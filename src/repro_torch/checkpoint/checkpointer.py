"""Fault-tolerant checkpointing — the port of
``repro.checkpoint.checkpointer``: atomic directory commits, async saves
and retention, in the reference's on-disk layout, so a checkpoint crosses
packages in either direction.

Layout:  <root>/step_<N>/{manifest.json, <flat__key__path>.npy, COMMITTED}
A checkpoint directory without the COMMITTED marker is ignored (a crash
mid-save never corrupts restore).

bfloat16 leaves are written as the reference writes them: ``.npy`` files
of 2-byte void elements (descr ``'<V2'``, the raw bfloat16 bits) with
``"bfloat16"`` in the manifest. ``restore`` reads each leaf by its
manifest dtype, so those bits come back as ``torch.bfloat16``; the
reference's own restore hands them back as raw ``|V2`` arrays. Restored
tensors land on CUDA unless the caller asks for ``device="cpu"``. Elastic
restore onto a mesh (``shardings=``) comes with the distributed slice
that shards training.
"""
from __future__ import annotations

import concurrent.futures
import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import TORCH_DTYPES
from repro_torch.device import resolve_device

SEP = "__"
BF16_DESCR = "<V2"


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
    else:
        out[SEP.join(prefix)] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _to_host(x: Any) -> Tuple[np.ndarray, str]:
    """A leaf → (numpy array to write, manifest dtype name). bfloat16
    tensors become their uint16 bits."""
    if torch.is_tensor(x):
        x = x.detach()
        # a copy: an async write must not see later in-place updates
        if x.dtype == torch.bfloat16:
            bits = x.view(torch.int16).to("cpu", copy=True)
            return bits.numpy().view(np.uint16), "bfloat16"
        x = x.to("cpu", copy=True).numpy()
    x = np.asarray(x)
    return x, str(x.dtype)


def _save_leaf(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    arr = np.require(arr, requirements="C")
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _load_leaf(path: Path, dtype: str, device: torch.device) -> torch.Tensor:
    arr = np.require(np.load(path), requirements=["C", "W"])
    if dtype == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device=device, dtype=TORCH_DTYPES[dtype])


class Checkpointer:
    """``device``: where :meth:`restore` puts tensors unless it is given
    one (CUDA unless 'cpu')."""

    def __init__(self, root: str | Path, keep: int = 3,
                 async_save: bool = True, device: Any = None):
        self.root = Path(root)
        self.device = device
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Copy ``tree`` (tensors or arrays) to the host now, write it on
        the background thread (or inline without ``async_save``)."""
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        if self.async_save:
            self.wait()
            self._pending = self._pool.submit(self._write, step, host, extra)
        else:
            self._write(step, host, extra)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]],
               extra: Optional[Dict]):
        final = self.root / f"step_{step:08d}"
        tmp = self.root / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra or {},
                    "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                               for k, (a, dt) in host.items()}}
        for k, (a, dt) in host.items():
            _save_leaf(tmp / f"{k}.npy", a, dt)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / "COMMITTED").write_text(str(time.time()))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in self.root.glob("step_*"):
            if (d / "COMMITTED").exists():
                out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, shardings: Any = None,
                device: Any = None) -> Tuple[Any, Dict]:
        """Load a checkpoint as a tree of tensors on ``device`` (the
        checkpointer's unless given), each leaf in its manifest dtype."""
        if shardings is not None:
            raise NotImplementedError("elastic restore onto a mesh comes with "
                                      "the distributed slice of the port "
                                      "that shards training")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.root}")
        device = resolve_device(self.device if device is None else device)
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {k: _load_leaf(d / f"{k}.npy", meta["dtype"], device)
                for k, meta in manifest["leaves"].items()}
        return _unflatten(flat), manifest["extra"]
