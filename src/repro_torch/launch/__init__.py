"""Launchers: the serving and training launchers, and the dry run's ZeRO-1
spec helpers."""
