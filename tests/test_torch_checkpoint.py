"""The port's checkpoints and fault-tolerance units: the counterparts of
tests/test_checkpoint.py (roundtrip, torn writes, garbage collection, shape
validation, elastic restore, data replay and its learnable signal) and
tests/test_fault_tolerance.py (the NaN skip-step, straggler detection, the
deadline-bounded prefetcher), plus the refusal of a JAX package's
checkpoint, whose format the port does not read."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jckpt  # noqa: E402

from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.parallel.sharding import P, shard_params  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.train.straggler import PrefetchIterator, StepTimer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": {"w": torch.randn((16, 8), generator=g).to(torch.bfloat16)},
        "b": [torch.randn((4,), generator=g), torch.randn((2, 2), generator=g)],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_roundtrip(tmp_path):
    t = _tree(0)
    ckpt.save(tmp_path, 3, t)
    latest = ckpt.latest(tmp_path)
    assert latest is not None and latest.name == "step_00000003"
    assert {p.name for p in latest.iterdir()} == {"meta.json", "shard_00000.bin", "COMMIT"}
    restored, meta = ckpt.restore(latest, t)
    assert meta["step"] == 3
    for a, b in zip(tree_leaves(t), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_torn_write_invisible(tmp_path):
    t = _tree(1)
    ckpt.save(tmp_path, 1, t)
    # simulate a crash mid-write of step 2: directory without COMMIT
    torn = tmp_path / "step_00000002"
    torn.mkdir()
    (torn / "meta.json").write_text("{}")
    (tmp_path / "step_00000003.tmp").mkdir()
    assert ckpt.latest(tmp_path).name == "step_00000001"


def test_gc_keeps_last(tmp_path):
    t = _tree(2)
    for s in range(5):
        ckpt.save(tmp_path, s, t, keep_last=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]


def test_shape_mismatch_rejected(tmp_path):
    t = _tree(3)
    ckpt.save(tmp_path, 0, t)
    bad = dict(t)
    bad["a"] = {"w": torch.zeros((8, 8), dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(ckpt.latest(tmp_path), bad)


def test_elastic_restore_resharding(tmp_path):
    """Leaves are stored logical: a checkpoint restores whole, and each rank
    of another layout cuts its own shard (``shard_params``), the port's
    counterpart of ``device_put`` with new shardings."""
    t = _tree(4)
    ckpt.save(tmp_path, 9, t)
    restored, _ = ckpt.restore(ckpt.latest(tmp_path), t)
    specs = {"a": {"w": P("model", None)}, "b": [P(None), P(None, "model")], "step": P()}
    for r in range(2):
        got = shard_params(restored, specs, r, 2)
        assert torch.equal(got["a"]["w"], t["a"]["w"][8 * r:8 * (r + 1)])
        assert torch.equal(got["b"][1], t["b"][1][:, r:r + 1])
        assert torch.equal(got["b"][0], t["b"][0]) and int(got["step"]) == 7


def test_jax_checkpoint_is_refused(tmp_path):
    """The port writes its own format (the standard library and numpy) and
    refuses the JAX package's, by its codec."""
    jckpt.save(tmp_path, 1, {"w": jnp.ones((2, 2), jnp.float32)})
    with pytest.raises(ValueError, match="codec"):
        ckpt.restore(ckpt.latest(tmp_path), {"w": torch.ones(2, 2)})


def test_data_pipeline_deterministic_replay():
    """Restoring at step k replays the exact batch stream (resumability)."""
    cfg = DataConfig(vocab=128, seq_len=32, global_batch=8, seed=5)
    d1 = SyntheticLM(cfg)
    d2 = SyntheticLM(cfg)
    for step in (0, 3, 17):
        b1 = d1.batch_at(step, shard=1, n_shards=2)
        b2 = d2.batch_at(step, shard=1, n_shards=2)
        assert torch.equal(b1["tokens"], b2["tokens"])
    # different shards are disjoint streams
    a = d1.batch_at(0, shard=0, n_shards=2)["tokens"]
    b = d1.batch_at(0, shard=1, n_shards=2)["tokens"]
    assert not torch.equal(a, b)


def test_markov_data_is_learnable_signal():
    """The synthetic stream must be compressible (loss << uniform)."""
    data = SyntheticLM(DataConfig(vocab=64, seq_len=64, global_batch=4, seed=0))
    toks = data.batch_at(0)["tokens"].numpy()
    pairs = {}
    for row in toks:
        for a, c in zip(row[:-1], row[1:]):
            pairs.setdefault(int(a), []).append(int(c))
    fracs = []
    for cs in pairs.values():
        _, counts = np.unique(cs, return_counts=True)
        if counts.sum() >= 8:
            fracs.append(np.sort(counts)[::-1][:8].sum() / counts.sum())
    assert np.mean(fracs) > 0.7, np.mean(fracs)


def test_nan_grad_skips_update():
    params = {"w": torch.ones((4, 4))}
    opt = adamw_init(params)
    bad = {"w": torch.full((4, 4), float("nan"))}
    newp, newopt, info = adamw_update(AdamWConfig(lr=1.0, warmup_steps=0), params, bad, opt)
    assert torch.equal(newp["w"], torch.ones((4, 4)))
    assert torch.isfinite(newopt["m"]["w"]).all() and int(newopt["step"]) == 1
    good = {"w": torch.ones((4, 4))}
    newp2, _, _ = adamw_update(AdamWConfig(lr=1.0, warmup_steps=0), newp, good, newopt)
    assert not torch.equal(newp2["w"], torch.ones((4, 4)))


def test_step_timer_flags_stragglers():
    t = StepTimer(threshold=3.0, patience=2, warmup_steps=2)
    for s in range(10):
        assert not t.observe(s, 1.0)
    assert t.observe(10, 10.0)  # 10x EMA
    assert not t.should_checkpoint_and_rebalance
    assert t.observe(11, 9.0)
    assert t.should_checkpoint_and_rebalance
    assert len(t.flagged_steps) == 2
    # recovery resets the escalation latch
    assert not t.observe(12, 1.0)
    assert not t.should_checkpoint_and_rebalance


def test_prefetch_reserves_on_missed_deadline():
    def fetch(step):
        if step == 2:
            time.sleep(0.6)  # simulated slow storage for batch 2
        return {"step": step}

    it = PrefetchIterator(fetch, deadline_s=0.25, depth=1)
    try:
        b0 = it.next()
        b1 = it.next()
        b2 = it.next()  # batch 2 is slow -> previous batch re-served
        assert b0["step"] == 0 and b1["step"] == 1
        assert b2["step"] == 1 and it.reserved_count >= 1
        for _ in range(6):  # the slow batch eventually arrives
            b3 = it.next()
            if b3["step"] == 2:
                break
        assert b3["step"] == 2
        assert it.served_steps[:2] == [0, 1] and it.served_steps[-1] == 2
    finally:
        it.close()
