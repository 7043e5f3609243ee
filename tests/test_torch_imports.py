"""The port stands alone: importing every module of ``repro_torch``
(the dry-run tooling included), everything ``chip_smoke.py`` imports and
every example of the port (``examples_torch/``) loads neither JAX nor
the JAX package.

Runs in a fresh interpreter, so that nothing this test process imported
(the parity tests import both packages) can hide an import.
"""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_port_and_chip_smoke_import_no_jax():
    code = textwrap.dedent(f"""
        import importlib, os, pkgutil, sys
        sys.path.insert(0, {os.path.join(ROOT, 'src')!r})
        sys.path.insert(0, {ROOT!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # its imports only: main() runs under __main__
        sys.path.insert(0, {os.path.join(ROOT, 'examples_torch')!r})
        examples = sorted(f[:-3] for f in os.listdir({os.path.join(ROOT, 'examples_torch')!r})
                          if f.endswith(".py"))
        for example in examples:  # the port's examples: main() runs under __main__
            importlib.import_module(example)
        names += ["examples_torch." + e for e in examples]
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
        print(len(names), bad, " ".join(names))
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 30, out.stdout
    # Every kernel wrapper, the MoE layer, the SpGEMM pipeline, the value
    # stream, the matrix file I/O, the plan cache, its disk tier, the
    # shard mesh, the performance models, the probe primitives, the
    # autotuner, the gateway and its metrics, the static analysis, the
    # buffering model, the paper-matrix config and the training stack
    # (optimizer, checkpoints, trainer, straggler detector, trees of
    # tensors, launcher) are among the modules imported.
    for name in ("repro_torch.kernels.bsr_spmm", "repro_torch.kernels.moe_gmm",
                 "repro_torch.kernels.flash_attention", "repro_torch.kernels.gustavson_spgemm",
                 "repro_torch.models.moe", "repro_torch.configs.qwen3_moe_30b_a3b",
                 "repro_torch.spgemm.pipeline", "repro_torch.data.pipeline",
                 "repro_torch.sparse.io", "repro_torch.spgemm.cache",
                 "repro_torch.spgemm.persist", "repro_torch.launch.mesh",
                 "repro_torch.core.perfmodel", "repro_torch.core.tuning",
                 "repro_torch.spgemm.autotune", "repro_torch.spgemm.gateway",
                 "repro_torch.runtime.heartbeat", "repro_torch.analysis",
                 "repro_torch.analysis.verify", "repro_torch.analysis.kernel_lint",
                 "repro_torch.analysis.locks", "repro_torch.analysis.check",
                 "repro_torch.core.buffering", "repro_torch.configs.paper_matrices",
                 "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.optim.clip",
                 "repro_torch.optim.schedules", "repro_torch.optim.compress",
                 "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
                 "repro_torch.runtime.trainer", "repro_torch.runtime.straggler",
                 "repro_torch.models.tree", "repro_torch.launch.train",
                 "repro_torch.launch.dryrun", "repro_torch.launch.refresh_corrections",
                 "examples_torch.quickstart", "examples_torch.spgemm_chain",
                 "examples_torch.spgemm_pipeline", "examples_torch.spgemm_gateway",
                 "examples_torch.serve_batched", "examples_torch.train_tiny_lm"):
        assert name in out.stdout.split(), name


def test_analysis_cli_runs_on_the_cpu():
    """The static-analysis CLI end to end on the CPU: kernel lint, the
    element, block, two-shard and rehydrated plans of poisson3Da at 1 %
    scale under ``validate="deep"``, and the lock-order lint."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.check", "--paper-matrices",
         "--matrices", "poisson3Da", "--scale", "0.01", "--device", "cpu", "--shards", "2",
         "--lock-lint"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240,
    )
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    for line in ("element", "block", "sharded x2", "rehydrated"):
        assert any(x.strip().startswith(line) and " ok " in x for x in out.stdout.splitlines()), (
            line, out.stdout)
    assert "acyclic: ok" in out.stdout and "all static checks passed" in out.stdout
