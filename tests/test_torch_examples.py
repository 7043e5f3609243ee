"""The port's examples (``examples_torch/``) on the CPU, each in a
subprocess at a small size with ``--device cpu`` (the quickstart touches
no device): each exits 0 and prints its last line. The quickstart's
printed numbers equal those of the JAX package's ``examples/quickstart.py``
line by line. ``train_tiny_lm.py`` runs in ``tests/test_torch_trainer.py``.
"""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]?\d+)?")


def _run(script: str, *args: str, timeout: int = 240) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, script), *args],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return out.stdout


def test_quickstart_prints_the_reference_numbers():
    ours = _run("examples_torch/quickstart.py").splitlines()
    theirs = _run("examples/quickstart.py").splitlines()
    assert len(ours) == len(theirs) and ours[-1] == "OK", (ours, theirs)
    for a, b in zip(ours, theirs):
        assert NUMBER.findall(a) == NUMBER.findall(b), (a, b)


# (script, arguments, lines the output must hold; its last line last).
CASES = [
    ("spgemm_chain.py", ("--scale", "0.01"),
     (r"triangles: chain trace\(A³\)/6 = (\d+), Hadamard sum\(A²∘A\)/6 = \1, oracle = \1",
      "OK")),
    ("spgemm_pipeline.py", ("--pipeline", "--steps", "2"),
     (r"execute_batch\(4\): all elements match single executes",
      r"sharded execute \+ execute_batch\(4\) match the single-device plan",
      r"pipeline: streamed 2 steps at depth 2", "OK")),
    ("spgemm_gateway.py", ("--bursts", "2"),
     (r"phase 1: 32/32 requests OK", r"bitwise check vs plan.execute: 6/6 equal",
      "admitted results verified; overload shed typed, nothing hung")),
    ("serve_batched.py", ("--requests", "3"),
     (r"served 3 requests / 36 tokens",
      r"prefill \(make_prefill_step\) agrees with the decoder's first token on 3 of 3", "OK")),
    ("serve_batched.py", ("--arch", "qwen3-moe-30b-a3b", "--requests", "2", "--max-new", "4"),
     (r"served 2 requests / 8 tokens", "OK")),
]


@pytest.mark.parametrize("script,args,expect", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_example_runs_on_the_cpu(script, args, expect):
    out = _run(os.path.join("examples_torch", script), "--device", "cpu", *args)
    lines = out.splitlines()
    assert lines[-1] == expect[-1], out[-2000:]
    for pattern in expect[:-1]:
        assert any(re.match(pattern, line) for line in lines), (pattern, out[-2000:])
