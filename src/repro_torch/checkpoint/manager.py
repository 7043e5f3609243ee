"""Fault-tolerant checkpointing.

The port of ``repro.checkpoint.manager``, with its guarantees:

* **atomicity** — writes go to ``step_<n>.tmp/`` and are renamed to
  ``step_<n>/`` only after every chunk and the manifest are fsynced; a
  crash mid-save never corrupts the latest checkpoint;
* **integrity** — the manifest records SHA256 per chunk; ``restore``
  verifies before use and refuses truncated/bit-rotten files;
* **retention** — keeps the newest ``keep`` checkpoints, deleting older
  ones only after a newer one is durable;
* **async** — ``save(..., blocking=False)`` snapshots to host memory
  synchronously (consistent view) and writes in a background thread.

And with its on-disk format, so that a checkpoint written by one package
restores in the other: ``manifest.json`` with ``step`` and ``chunks``
(``index``, ``path``, ``file``, ``shape``, ``dtype``, ``stored_dtype``,
``sha256``), one ``chunk_%05d.npy`` per leaf in JAX's leaf order, and
bfloat16 stored as its raw ``uint16`` bits under the logical dtype
``"bfloat16"``. Trees are nested dicts, lists and tensors, and
``ParamTree`` / ``ModuleList`` modules (:mod:`repro_torch.models.tree`);
leaf paths are spelled as ``jax.tree_util.keystr`` spells them.

Chunks hold whole tensors, so a checkpoint restores onto any device:
each leaf goes to the device and dtype of its counterpart in ``like``.
The reference's ``shardings`` argument (reshard-on-load over a mesh) has
no counterpart on one card.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.tree import flatten_with_paths, tree_rebuild

__all__ = ["CheckpointManager"]


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_host(x: torch.Tensor):
    """(array to store, logical dtype name): a copy on the host, so that the
    snapshot holds even if training writes the tensor in place later.
    Numpy has no bfloat16: such a chunk holds the raw bits as uint16 (the
    reference's ``arr.view("u2")``) under the logical dtype "bfloat16"."""
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_stored(arr: np.ndarray, logical: str) -> torch.Tensor:
    """The tensor of a loaded chunk (``np.load`` returns a fresh C-ordered
    array): raw bits viewed back to their logical dtype."""
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        self.wait()  # one async save in flight at a time
        # Snapshot to host memory synchronously: consistent view even if
        # training mutates tensors afterwards.
        flat = flatten_with_paths(tree)
        host = [_to_host(x) for _, x in flat]
        paths = [p for p, _ in flat]

        def write():
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest: Dict[str, Any] = {"step": step, "chunks": []}
            for i, ((stored, logical), p) in enumerate(zip(host, paths)):
                fn = f"chunk_{i:05d}.npy"
                fp = os.path.join(tmp, fn)
                with open(fp, "wb") as f:
                    np.save(f, stored)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["chunks"].append(
                    {
                        "index": i,
                        "path": p,
                        "file": fn,
                        "shape": list(stored.shape),
                        "dtype": logical,
                        "stored_dtype": str(stored.dtype),
                        "sha256": _sha256(fp),
                    }
                )
            mf = os.path.join(tmp, "manifest.json")
            with open(mf, "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()

        if blocking:
            write()
        else:
            def run():
                try:
                    write()
                except BaseException as e:  # surfaced on next wait()
                    self._error = e

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- introspection -----------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- restore -----------------------------------------------------------
    def restore(self, step: int, like: Any, verify: bool = True) -> Any:
        """Restore into the structure of ``like``: a new tree of its
        container types, each leaf on its counterpart's device in its
        counterpart's dtype. Raises if the leaf count, a leaf's path or a
        shape differs, or (with ``verify``) a chunk's SHA256 does."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = flatten_with_paths(like)
        if len(manifest["chunks"]) != len(flat):
            raise ValueError(
                f"checkpoint has {len(manifest['chunks'])} leaves, "
                f"target structure has {len(flat)}"
            )
        out = []
        for rec, (path, ref) in zip(manifest["chunks"], flat):
            if rec["path"] != path:
                raise ValueError(f"leaf {rec['index']}: checkpoint path {rec['path']}, "
                                 f"target path {path}")
            fp = os.path.join(d, rec["file"])
            if verify and _sha256(fp) != rec["sha256"]:
                raise IOError(f"checkpoint chunk corrupt: {fp}")
            t = _from_stored(np.load(fp), rec["dtype"])
            if list(t.shape) != list(ref.shape):
                raise ValueError(
                    f"shape mismatch for {rec['path']}: "
                    f"{tuple(t.shape)} vs {tuple(ref.shape)}"
                )
            out.append(t.to(ref.device, ref.dtype))
        return tree_rebuild(like, out)
