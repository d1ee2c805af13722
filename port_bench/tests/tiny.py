"""Small cells for the CPU tests: the benchmark's configurations at a few
dozen channels and two layers, with the same kinds of layers."""
import copy

import spec


def tiny_cell(workload: str):
    cell = spec.load_cell(workload)
    cfg = copy.deepcopy(cell.config)
    p = cfg["port"]
    p.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, vocab=256)
    if p.get("n_experts"):
        p.update(n_experts=5, top_k=2, d_ff_expert=32, vocab_padded=264)
        # five experts flip their top-2 under bf16 rounding far more often
        # than the cell's 40 do their top-8: over eight seeds the CPU read
        # the program's gap_mean at 0.0016-0.0245 and flip_pct at 2.3-6.3,
        # the control's at 0.072-0.116 and 25-34
        cell.limits = {"gap_mean": 0.045, "flip_pct": 13.0}
    else:
        p.update(d_ff=96)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, lengths=[[32, 2], [64, 1]],
                        batch=min(cell.traffic["batch"], 4))
    return cell
