"""ROADMAP's IR-parity table: base/dist nodes and facts of the port's and
the JAX package's pairs at full width (tp 4, stamped, unless the row says
otherwise), on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/ir_parity_table.py

Prints one Markdown row a plan."""
from repro.verify import Plan as JPlan
from repro.verify import Session as JSession
from repro_torch.verify import Plan, Session

ROWS = [  # (label, arch, plan keywords)
    ("llama3_8b tp-forward", "llama3_8b", {"tp": 4}),
    ("llama3_8b tp-decode", "llama3_8b", {"tp": 4, "mode": "decode"}),
    ("llama3_8b sp-forward", "llama3_8b", {"tp": 4, "sp": True}),
    ("qwen3_4b tp-forward", "qwen3_4b", {"tp": 4}),
    ("mamba2_130m tp-forward", "mamba2_130m", {"tp": 4}),
    ("mamba2_130m tp-decode", "mamba2_130m", {"tp": 4, "mode": "decode"}),
    ("gemma_2b dp-forward (dp 2, full depth)", "gemma_2b", {"dp": 2}),
    ("llama3_405b tp-forward (tp 16)", "llama3_405b", {"tp": 16}),
    ("hubert_xlarge tp-forward", "hubert_xlarge", {"tp": 4}),
    ("internvl2_26b sp-forward", "internvl2_26b", {"tp": 4, "sp": True}),
]


def cell(rep) -> str:
    return f"{rep.num_base_nodes}/{rep.num_dist_nodes}, {rep.num_facts}"


def main() -> None:
    print("| Plan | Port | JAX |\n|---|---|---|")
    for label, arch, kw in ROWS:
        with Session() as s, JSession() as js:
            got, want = s.verify(arch, Plan(**kw)), js.verify(arch, JPlan(**kw))
        print(f"| {label} | {cell(got)} | {cell(want)} |", flush=True)
    kw = {"dp": 2, "layers": 2, "seq": 8}
    with Session() as s, JSession() as js:
        got, want = s.verify("qwen3_4b", Plan.grad(**kw)), js.verify("qwen3_4b",
                                                                      JPlan.grad(**kw))
    for tag, r in (("got", got), ("want", want)):
        print(tag, cell(r), "VERIFIED" if r.verified else "FAILED")
    with Session() as s, JSession() as js:
        got, want = s.verify("mamba2_130m", Plan.grad(**kw)), js.verify("mamba2_130m",
                                                                         JPlan.grad(**kw))
    for tag, r in (("got", got), ("want", want)):
        print("mamba2_130m", tag, cell(r), "VERIFIED" if r.verified else "FAILED")


if __name__ == "__main__":
    main()
