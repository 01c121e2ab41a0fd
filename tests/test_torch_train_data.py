"""The port's training input and state: the AutoMDT-tuned input pipeline
(``repro_torch.data``, a copy of ``repro.data``) against the reference's
rows byte for byte; checkpoints through the transfer engine, whose
``ckpt.bin`` equals the direct save's and the reference's byte for byte,
and bf16 leaves read back across the two packages; ``AsyncCheckpointer``
and ``FaultTolerantTrainer`` in the cases of the reference's own tests
(``tests/test_pipeline_checkpoint_runtime.py``), and a resumed train step
equal to an uninterrupted one. Every blocking call has a timeout of at
least 30 s; nothing asserts on wall-clock time."""

import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

torch.set_num_threads(2)

from repro.checkpoint import (save_checkpoint as j_save,
                              load_checkpoint as j_load)
from repro.data import InputPipeline as JPipeline
from repro.data import SyntheticTokenSource as JSource

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.data import InputPipeline
from repro_torch.launch import steps
from repro_torch.runtime import (FaultTolerantTrainer, HeartbeatRegistry,
                                 StragglerDetector, WorkerFailure)

TIMEOUT = 30.0


def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn((8, 16), generator=g),
                       "b": torch.randn((16,), generator=g).to(
                           torch.bfloat16)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}


def _zeros_like(state):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in state["params"].items()},
            "opt": {"step": torch.zeros_like(state["opt"]["step"])}}


def _jax_state(state):
    """The same values as JAX arrays (bf16 stays bf16)."""
    p = state["params"]
    return {"params": {"w": jnp.asarray(p["w"].numpy()),
                       "b": jnp.asarray(p["b"].float().numpy(),
                                        jnp.bfloat16)},
            "opt": {"step": jnp.asarray(int(state["opt"]["step"]),
                                        jnp.int32)}}


def _read(path):
    with open(os.path.join(path, "ckpt.bin"), "rb") as f:
        blob = f.read()
    with open(os.path.join(path, "manifest.json")) as f:
        return blob, json.load(f)


def test_input_pipeline_delivers_int32_batches_on_the_device():
    pipe = InputPipeline(vocab=128, batch=4, seq=16, total_rows=32)
    try:
        b1 = pipe.next_batch(timeout=TIMEOUT, device="cpu")
        b2 = pipe.next_batch(timeout=TIMEOUT, device="cpu")
    finally:
        pipe.close()
    for b in (b1, b2):
        assert set(b) == {"tokens", "labels"}
        for t in b.values():
            assert t.shape == (4, 16) and t.dtype == torch.int32
            assert t.device.type == "cpu"
    # labels are the shifted tokens of the same rows
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert not torch.equal(b1["tokens"], b2["tokens"])


def test_pipeline_batches_equal_the_reference_rows():
    """One thread a stage keeps the rows in order; each batch is then the
    reference pipeline's, and each row the reference corpus's row."""
    kw = dict(vocab=128, batch=4, seq=16, total_rows=16,
              initial_concurrency=(1, 1, 1), seed=3)
    pipes = [InputPipeline(**kw), JPipeline(**kw)]
    try:
        mine = [pipes[0].next_batch(timeout=TIMEOUT, device="cpu")
                for _ in range(4)]
        ref = [pipes[1].next_batch(timeout=TIMEOUT) for _ in range(4)]
    finally:
        for p in pipes:
            p.close()
    src = JSource(128, 16, 16, seed=3)
    for i, (m, r) in enumerate(zip(mine, ref)):
        for k in ("tokens", "labels"):
            got = m[k].numpy()
            want = np.asarray(r[k])
            assert got.dtype == want.dtype == np.int32
            assert got.tobytes() == want.tobytes()
        rows = np.stack([src.row(4 * i + j) for j in range(4)])
        assert m["tokens"].numpy().tobytes() == rows[:, :-1].tobytes()


def test_engine_save_writes_the_direct_and_the_reference_saves_bytes(
        tmp_path):
    state = _state()
    engine = save_checkpoint(str(tmp_path / "engine"), state, 7,
                             chunk_bytes=64)
    direct = save_checkpoint(str(tmp_path / "direct"), state, 7,
                             use_engine=False)
    ref = j_save(str(tmp_path / "ref"), _jax_state(state), 7,
                 use_engine=False)
    blobs = [_read(p) for p in (engine, direct, ref)]
    assert blobs[0][0] == blobs[1][0] == blobs[2][0]
    assert blobs[0][1] == blobs[1][1] == blobs[2][1]   # index and sha256
    index = {e[0]: e for e in blobs[0][1]["index"]}
    assert index["params/b"][1] == "bfloat16"
    assert index["opt/step"][1] == "int32"


def test_bf16_checkpoints_read_back_across_the_packages(tmp_path):
    state = _state()
    j_save(str(tmp_path / "ref"), _jax_state(state), 2)
    back, step = load_checkpoint(str(tmp_path / "ref"), _zeros_like(state))
    assert step == 2
    assert back["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["b"], state["params"]["b"])
    assert torch.equal(back["params"]["w"], state["params"]["w"])
    assert int(back["opt"]["step"]) == 3

    save_checkpoint(str(tmp_path / "port"), state, 5)
    jback, step = j_load(str(tmp_path / "port"), _jax_state(_zeros_like(
        state)))
    assert step == 5 and jback["params"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jback["params"]["b"], np.float32),
        state["params"]["b"].float().numpy())
    np.testing.assert_array_equal(np.asarray(jback["params"]["w"]),
                                  state["params"]["w"].numpy())


def test_checkpoint_roundtrip_corruption_and_pruning(tmp_path):
    state = _state()
    path = save_checkpoint(str(tmp_path / "a"), state, 7)
    restored, step = load_checkpoint(str(tmp_path / "a"), _zeros_like(state))
    assert step == 7
    for k, v in state["params"].items():
        assert restored["params"][k].dtype == v.dtype
        assert torch.equal(restored["params"][k], v)
    with open(os.path.join(path, "ckpt.bin"), "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff\xff")
    with pytest.raises(IOError, match="corrupt"):
        load_checkpoint(str(tmp_path / "a"), _zeros_like(state))
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path / "b"), state, s, keep=2)
    assert latest_step(str(tmp_path / "b")) == 5
    assert sorted(os.listdir(tmp_path / "b")) == ["step_4", "step_5"]


def test_async_checkpointer_supersedes_and_hands_an_error_off_once(tmp_path):
    state = _state()
    saver = AsyncCheckpointer(str(tmp_path / "ok"))
    saver.save(state, 10)
    saver.save(state, 20)  # supersedes/queues
    saver.wait()
    assert latest_step(str(tmp_path / "ok")) in (10, 20)
    assert saver.saves and saver.saves[-1]["step"] == 20
    assert saver.saves[-1]["bytes"] == 8 * 16 * 4 + 16 * 2 + 4
    restored, _ = load_checkpoint(str(tmp_path / "ok"), _zeros_like(state))
    assert torch.equal(restored["params"]["w"], state["params"]["w"])

    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    bad = AsyncCheckpointer(str(blocker))
    bad.save(state, 1)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()   # handed off once: the next wait does not raise again


def test_fault_tolerant_trainer_restarts(tmp_path):
    """Inject a failure mid-run; the trainer restores from the checkpoint and
    completes with the exact same final state as an uninterrupted run."""

    def step_fn(state, batch):
        return {"x": state["x"] + batch}, {"x": float(state["x"])}

    def batch_fn(cursor):
        return torch.tensor(float(cursor + 1))

    total = 30
    ft0 = FaultTolerantTrainer(str(tmp_path / "ref"), ckpt_every=5)
    ref, rep0 = ft0.run(step_fn, {"x": torch.tensor(0.0)}, batch_fn, total)
    assert rep0.restarts == 0

    failed = {"done": False}

    def chaos(step):
        if step == 17 and not failed["done"]:
            failed["done"] = True
            raise WorkerFailure("injected preemption at step 17")

    ft = FaultTolerantTrainer(str(tmp_path / "chaos"), ckpt_every=5)
    out, rep = ft.run(step_fn, {"x": torch.tensor(0.0)}, batch_fn, total,
                      chaos=chaos)
    assert rep.restarts == 1 and rep.checkpoints == 6   # 5, 10, 15, 20, 25, 30
    assert rep.steps_run == total + 2    # steps 15 and 16 ran twice
    assert float(out["x"]) == float(ref["x"]) == total * (total + 1) / 2


def test_a_resumed_train_step_equals_an_uninterrupted_run(tmp_path):
    """The SMOKE smollm's real train step (bf16 parameters, float32
    moments) through a failure at step 5 and a trainer restarted over the
    same directory: the final state equals the uninterrupted run's."""
    cfg = get_smoke_config("smollm-135m")
    init = steps.init_state(cfg, 0, device="cpu")
    step_fn = steps.make_train_step(cfg, warmup_steps=2, total_steps=8)
    rng = np.random.default_rng(4)
    rows = rng.integers(0, cfg.vocab, (8, 2, 17), dtype=np.int32)

    def batch_fn(cursor):
        return {"tokens": torch.from_numpy(rows[cursor, :, :-1].copy()),
                "labels": torch.from_numpy(rows[cursor, :, 1:].copy())}

    state = init
    for c in range(8):
        state, _ = step_fn(state, batch_fn(c))

    def chaos(step):
        if step == 5 and not chaos.fired:
            chaos.fired = True
            raise WorkerFailure("injected")
    chaos.fired = False

    ft = FaultTolerantTrainer(str(tmp_path), ckpt_every=3)
    out, rep = ft.run(step_fn, init, batch_fn, 6, chaos=chaos)
    assert rep.restarts == 1 and latest_step(str(tmp_path)) == 6
    again = FaultTolerantTrainer(str(tmp_path), ckpt_every=3)   # a new process
    out, rep = again.run(step_fn, init, batch_fn, 8)
    assert rep.steps_run == 2
    assert out["params"]["embed.embed"].dtype == torch.bfloat16
    for part, want, got in (("params", state["params"], out["params"]),
                            ("m", state["opt"]["m"], out["opt"]["m"]),
                            ("v", state["opt"]["v"], out["opt"]["v"])):
        for n in want:
            assert torch.equal(want[n], got[n]), (part, n)
    assert int(out["opt"]["step"]) == 8


def test_straggler_detector():
    reg = HeartbeatRegistry()
    det = StragglerDetector(reg, slow_factor=1.5, dead_after=3600.0)
    for w in range(6):
        reg.beat(f"w{w}", step=10, step_time=1.0)
    reg.beat("w6", step=10, step_time=3.0)  # straggler
    rep = det.report()
    assert rep["stragglers"] == ["w6"]
    assert rep["dead"] == []
    assert rep["median_step_time"] == pytest.approx(1.0)
    assert StragglerDetector(HeartbeatRegistry()).report() == {
        "stragglers": [], "dead": [], "median_step_time": None}
