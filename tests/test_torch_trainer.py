"""The fault-tolerant training loop of the port: ``CheckpointManager``
(atomicity, integrity, retention, async snapshots, and checkpoints that
cross between the two packages bitwise), ``Trainer`` (resume after a
simulated preemption), ``launch_train`` and its CLI, and
``examples_torch/train_tiny_lm.py``, all on the CPU at a few steps of the
reduced granite-3-2b.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as RCheckpointManager  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.train import launch_train  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.nn import ParamTree  # noqa: E402
from repro_torch.models.tree import flatten_with_paths, tree_leaves  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCH = "granite-3-2b"


def _np_leaves():
    """float32, bfloat16 (as float32 values) and int32 leaves of one tree."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((3, 4)).astype(np.float32),
            rng.standard_normal((5,)).astype(np.float32),
            rng.integers(-9, 9, (2, 2)).astype(np.int32))


def _torch_tree():
    f, b, i = _np_leaves()
    return {"w": torch.from_numpy(f), "layers": [{"b": torch.from_numpy(b).to(torch.bfloat16)},
                                                 {"n": torch.from_numpy(i)}],
            "step": torch.tensor(7, dtype=torch.int32)}


def _jax_tree():
    f, b, i = _np_leaves()
    return {"w": jnp.asarray(f), "layers": [{"b": jnp.asarray(b).astype(jnp.bfloat16)},
                                            {"n": jnp.asarray(i)}],
            "step": jnp.asarray(7, jnp.int32)}


def _bits(x) -> np.ndarray:
    """The raw bytes of a leaf, whichever package holds it."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    x = np.asarray(x)
    return x.view(np.int16).tobytes() if x.dtype.itemsize == 2 else x.tobytes()


# -- CheckpointManager ---------------------------------------------------------

def test_save_restore_bitwise_and_types(tmp_path):
    """A tree of dicts, lists and f32 / bf16 / int32 tensors, and a
    ParamTree / ModuleList module, round-trip bitwise with their container
    types, dtypes and ``requires_grad``."""
    mgr = CheckpointManager(str(tmp_path))
    params = tr.init_lm(0, get_reduced(ARCH), device="cpu", trainable=True)
    tree = {"t": _torch_tree(), "params": params}
    mgr.save(3, tree)
    out = mgr.restore(3, tree)
    assert isinstance(out["params"], ParamTree)
    assert isinstance(out["params"]["layers"], nn.ModuleList)
    assert isinstance(out["t"]["layers"], list)
    for (pa, a), (pb, b) in zip(flatten_with_paths(out), flatten_with_paths(tree)):
        assert pa == pb and a.dtype == b.dtype and a.requires_grad == b.requires_grad
        assert _bits(a.detach()) == _bits(b.detach()), pa
    assert any(p.requires_grad for p in out["params"].parameters())


def test_leftover_tmp_is_ignored(tmp_path):
    """A ``step_<n>.tmp`` directory (a crash mid-save) is never listed or
    restored; a later save of that step replaces it."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _torch_tree()
    mgr.save(1, tree)
    os.makedirs(tmp_path / "step_000000009.tmp")
    (tmp_path / "step_000000009.tmp" / "chunk_00000.npy").write_bytes(b"partial")
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    mgr.save(9, tree)
    assert mgr.all_steps() == [1, 9]
    assert not (tmp_path / "step_000000009.tmp").exists()


def test_corrupted_chunk_is_refused(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _torch_tree()
    mgr.save(5, tree)
    with open(tmp_path / "step_000000005" / "chunk_00001.npy", "r+b") as f:
        f.seek(-8, 2)
        f.write(b"corrupt!")
    with pytest.raises(IOError, match="corrupt"):
        mgr.restore(5, tree)


def test_restore_refuses_another_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _torch_tree()
    mgr.save(1, tree)
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, {"w": tree["w"]})
    renamed = dict(tree, v=tree.pop("w"))
    with pytest.raises(ValueError, match="path"):
        mgr.restore(1, renamed)
    renamed["w"] = renamed.pop("v")[:2]
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, renamed)


def test_retention_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((4,), float(s))})
    assert mgr.all_steps() == [3, 4]
    assert float(mgr.restore(3, {"x": torch.zeros(4)})["x"][0]) == 3.0


def test_async_save_snapshots_before_returning(tmp_path):
    """``blocking=False`` copies every leaf to the host before it returns:
    writing the tensors in place afterwards (as the optimizer does) does
    not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _torch_tree()
    want = [_bits(x) for x in tree_leaves(tree)]
    mgr.save(2, tree, blocking=False)
    for x in tree_leaves(tree):
        x.add_(1)
    mgr.wait()
    assert mgr.all_steps() == [2]
    got = mgr.restore(2, tree)
    assert [_bits(x) for x in tree_leaves(got)] == want


def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path):
    """The JAX package writes; the port restores every leaf bitwise, and
    reads the same manifest it would have written."""
    RCheckpointManager(str(tmp_path / "jax")).save(4, _jax_tree())
    CheckpointManager(str(tmp_path / "torch")).save(4, _torch_tree())
    out = CheckpointManager(str(tmp_path / "jax")).restore(4, _torch_tree())
    for (path, a), b in zip(flatten_with_paths(out), jax.tree.leaves(_jax_tree())):
        assert _bits(a) == _bits(b), path
    manifests = [json.loads((tmp_path / pkg / "step_000000004" / "manifest.json").read_text())
                 for pkg in ("jax", "torch")]
    assert manifests[0] == manifests[1]
    assert [c["dtype"] for c in manifests[0]["chunks"]] == ["bfloat16", "int32", "int32",
                                                            "float32"]
    assert manifests[0]["chunks"][0]["stored_dtype"] == "uint16"


def test_port_checkpoint_restores_in_the_reference_bitwise(tmp_path):
    CheckpointManager(str(tmp_path)).save(6, _torch_tree())
    out = RCheckpointManager(str(tmp_path)).restore(6, _jax_tree())
    for a, b in zip(jax.tree.leaves(out), tree_leaves(_torch_tree())):
        assert a.dtype == jnp.dtype(str(b.dtype).replace("torch.", ""))
        assert _bits(a) == _bits(b)


# -- Trainer -------------------------------------------------------------------

def _trainer(ckpt_dir, total, start_batch=0, on_metrics=None):
    cfg = get_reduced(ARCH)
    params = tr.init_lm(0, cfg, device="cpu", trainable=True)
    opt = AdamW(lr=1e-3)
    data = SyntheticLM(cfg, 2, 16)

    def batches():
        s = start_batch
        while True:
            yield {k: torch.from_numpy(v) for k, v in data.batch_at(s).items()}
            s += 1

    tc = TrainerConfig(total_steps=total, ckpt_dir=str(ckpt_dir), ckpt_every=2, log_every=1,
                       install_signal_handlers=False, heartbeat=False)
    return Trainer(tc, make_train_step(cfg, opt), batches(), params, opt.init(params),
                   on_metrics=on_metrics)


def test_trainer_resumes_after_preemption_at_the_saved_step(tmp_path):
    """A preemption flag raised after step 1 ends the run at that step
    boundary with a checkpoint of step 1; a fresh Trainer over the same
    directory resumes there and runs to step 3, bitwise equal to an
    uninterrupted 3-step run (the batches continue at the saved step)."""
    holder = {}

    def preempt(step, rec):
        if step == 1:
            holder["t"]._preempted = True

    t1 = _trainer(tmp_path / "a", total=3, on_metrics=preempt)
    holder["t"] = t1
    res = t1.run()
    assert res["preempted"] and res["final_step"] == 1
    assert t1.ckpt.latest_step() == 1
    t2 = _trainer(tmp_path / "a", total=3, start_batch=1)
    res2 = t2.run()
    assert res2["final_step"] == 3 and not res2["preempted"]
    assert [h["step"] for h in res2["history"]] == [2, 3]
    assert t2.ckpt.all_steps() == [1, 2, 3]
    straight = _trainer(tmp_path / "b", total=3)
    straight.run()
    assert int(t2.opt_state["step"]) == int(straight.opt_state["step"]) == 3
    for a, b in zip(tree_leaves({"p": t2.params, "o": t2.opt_state}),
                    tree_leaves({"p": straight.params, "o": straight.opt_state})):
        assert torch.equal(a.detach(), b.detach())


def test_launch_train_resumes_bitwise_and_lowers_the_loss(tmp_path):
    """``launch_train`` on the CPU (reduced granite, 12 steps of 8 x 32,
    checkpoints every 4) lowers the loss; a second launch over the same
    directory resumes at step 12 and holds the saved params and optimizer
    state bitwise."""
    kw = dict(steps=12, batch=8, seq=32, ckpt_dir=str(tmp_path), log_every=4, ckpt_every=4,
              device="cpu")
    res = launch_train(ARCH, **kw)
    losses = [h["loss"] for h in res["history"]]
    assert res["final_step"] == 12 and losses[-1] < losses[0]
    again = launch_train(ARCH, **dict(kw, seed=1))
    assert again["final_step"] == 12 and again["history"] == []
    for a, b in zip(tree_leaves({"p": again["params"], "o": again["opt_state"]}),
                    tree_leaves({"p": res["params"], "o": res["opt_state"]})):
        assert torch.equal(a.detach(), b.detach())


def test_launch_train_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--steps", "2",
         "--batch", "2", "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "done: 2 steps, preempted=False" in out.stdout
    assert CheckpointManager(str(tmp_path)).latest_step() == 2


def test_train_tiny_lm_example_lowers_the_loss():
    """30 steps at the example's learning rate; a batch of 64 sequences
    keeps the batch-to-batch spread of the loss (~0.05 at 8 sequences,
    in the JAX package's example too) below what 30 steps gain."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples_torch", "train_tiny_lm.py"),
         "--device", "cpu", "--steps", "30", "--batch", "64", "--seq", "32"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "training reduced loss" in out.stdout
