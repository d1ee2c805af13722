"""The plain references the benchmark holds the program to (imports nothing of it)."""
