"""BENCHMARK.json against its format's rules (names, units, keys, bounds), and every piece of
every cell found by name."""
import hashlib
import json
import re
import shutil

import pytest

import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    assert len(names) == len(set(names))
    metrics = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_entry_keys():
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    for e in BENCH["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert "setup_s" in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["port"] and c.traffic["kind"] == "prefill"
    assert c.limits, "the cell's limits file"
    assert (spec.HERE / f"{c.traffic['kind']}.py").exists()
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_moves_reported_in_each_cell(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    for cell in m.get("workloads", CELLS):
        assert m["moves"] in {e["name"] for e in spec.load_cell(cell).end_to_end}, cell


def test_configs_hold_their_published_widths():
    for c in BENCH["configs"]:
        f = spec.load_json(spec.ROOT / c["file"])
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        p = f["port"]
        widths = {"chatglm": (("hidden_size", "d_model"), ("num_attention_heads", "n_heads"),
                              ("multi_query_group_num", "n_kv_heads"),
                              ("kv_channels", "head_dim"), ("ffn_hidden_size", "d_ff"),
                              ("padded_vocab_size", "vocab"), ("num_layers", "n_layers")),
                  "granitemoe": (("hidden_size", "d_model"), ("num_attention_heads", "n_heads"),
                                 ("num_key_value_heads", "n_kv_heads"),
                                 ("intermediate_size", "d_ff_expert"),
                                 ("num_local_experts", "n_experts"),
                                 ("num_experts_per_tok", "top_k"),
                                 ("vocab_size", "vocab"), ("num_hidden_layers", "n_layers"))}
        for hf, port in widths[f["model_type"]]:
            assert f[hf] == p[port], (c["name"], hf)
        for k in f["reduced"]:
            assert k in f["published"] and f["published"][k] != f[k]


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_mix_and_a_metric_added_as_files(tmp_path):
    """A later change adds a traffic mix, a cell and a per-layer metric by
    new files and entries alone; the harness finds them by name."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root / "port_bench")
    first = BENCH["workloads"][0]
    (root / "port_bench" / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"kind": "prefill", "batch": 2, "lengths": [[128, 1]]}))
    (root / "port_bench" / "limits" / "dummy.cell.json").write_text(json.dumps(
        {"limits": {"gap_max": 1.0}}))
    (root / "port_bench" / "metrics" / "dummy_units.py").write_text(
        "def read(f):\n    return f['units']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy.cell", "config": first["config"],
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_units", "unit": "units", "better": "higher",
                               "source": "program_counter", "layer": "a test",
                               "moves": "prefill_tokens_per_s", "workloads": ["dummy.cell"]})
    bench["end_to_end"] = [dict(e, workloads=e["workloads"] + ["dummy.cell"])
                           if "workloads" in e and "prefill_tokens_per_s" == e["name"] else e
                           for e in bench["end_to_end"]]
    cell = spec.load_cell("dummy.cell", bench, root)
    assert cell.traffic["lengths"] == [[128, 1]] and cell.limits == {"gap_max": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["dummy_units"]
    got = spec.read_metrics(cell.per_layer, {"units": 7}, root)
    assert got == {"dummy_units": {"value": 7.0, "unit": "units"}}
    after = _digests(root / "port_bench")
    assert {p: d for p, d in after.items() if p in before} == before


def test_idle_share_at_the_windows_pace():
    """3 busy seconds over 1,000 traced tokens, at the window's 250 tokens
    a second: the card is busy 75% of the window."""
    read = spec.reader("device_idle_pct.prefill")
    assert read({"kind": "prefill", "busy": {"busy_s": 3.0, "window_s": 4.0, "tokens": 1000},
                 "tokens": 500, "elapsed_s": 2.0}) == 25.0
    assert read({"kind": "prefill", "tokens": 500, "elapsed_s": 2.0}) is None
