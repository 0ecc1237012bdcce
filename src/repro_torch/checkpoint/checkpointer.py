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
tensors land on CUDA unless the caller asks for ``device="cpu"``.

Placed leaves (``runtime/placement``: DTensors of a sharded train step)
are gathered on every rank inside :meth:`save`, before the writer thread
sees them (a collective on that thread would deadlock the ranks); the
mesh's first rank copies them to the host and writes: the files are the
single-device ones, byte for byte. In a rank group :meth:`wait` is also
a barrier, so every rank can read what was written.
``restore(shardings=)`` places each leaf named there on its mesh: this
rank reads its chunk of the file.
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
import torch.distributed as dist

from repro_torch.convert import TORCH_DTYPES
from repro_torch.device import resolve_device
from repro_torch.runtime import placement as plc

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


def _load_leaf(path: Path, dtype: str, device: torch.device,
               sharding: Any = None) -> torch.Tensor:
    """A leaf in its manifest dtype on ``device``; with a ``sharding``
    (a ``runtime/sharding.NamedSharding``) this rank's chunk, read from
    the memory-mapped file, placed on its mesh."""
    if sharding is None:
        arr = np.require(np.load(path), requirements=["C", "W"])
    else:
        mm = np.load(path, mmap_mode="r")
        arr = np.array(mm[plc.chunk_slices(mm.shape, sharding.mesh,
                                           sharding.placements)])
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    else:
        t = torch.from_numpy(arr).to(device=device, dtype=TORCH_DTYPES[dtype])
    if sharding is None:
        return t
    return plc.from_chunk(t, sharding, mm.shape)


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
        self._mesh: Any = None        # the mesh of the last placed save

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Copy ``tree`` (tensors or arrays) to the host now, write it on
        the background thread (or inline without ``async_save``). A tree
        of placed leaves is gathered on every rank of its mesh (each must
        call this) and written by the mesh's first rank."""
        self.wait()
        flat = _flatten(tree)
        mesh = self._mesh = plc.placed_mesh(flat)
        writer = mesh is None or dist.get_rank() == int(mesh.mesh.flatten()[0])
        host = {}
        for k, v in flat.items():
            v = plc.gather_full(v)          # a collective: every rank joins
            if writer:
                host[k] = _to_host(v)
        if not writer:
            return
        if self.async_save:
            self._pending = self._pool.submit(self._write, step, host, extra)
        else:
            self._write(step, host, extra)

    def wait(self):
        """Wait for the pending write; after a placed save, also for every
        rank of its mesh (a barrier), so each can read the files."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            dev = "cpu" if mesh.device_type == "cpu" else torch.cuda.current_device()
            token = torch.zeros(1, device=dev)
            for i in range(mesh.ndim):
                dist.all_reduce(token, group=mesh.get_group(i))

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
        checkpointer's unless given), each leaf in its manifest dtype.
        ``shardings``: a tree of ``NamedSharding`` (``runtime/sharding``,
        a sub-tree of the checkpoint's) — elastic restore: each leaf named
        there is placed on its (possibly different) mesh, this rank
        reading only its chunk."""
        flat_s = _flatten(shardings) if shardings is not None else {}
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.root}")
        device = resolve_device(self.device if device is None else device)
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {k: _load_leaf(d / f"{k}.npy", meta["dtype"], device,
                              flat_s.get(k))
                for k, meta in manifest["leaves"].items()}
        return _unflatten(flat), manifest["extra"]
