"""Fault-tolerant checkpointing: atomic, async, keep-K, exact resume (port
of ``repro/checkpoint/checkpointing.py``, in the reference's file format).

  * **atomic**: write to ``step_N.tmp-<pid>`` then ``os.replace`` — a crash
    mid-save never corrupts the latest checkpoint;
  * **async**: the device→host copy happens on the caller thread (the train
    step updates its state in place right after), serialization + fsync on
    a background thread so the train loop keeps stepping;
  * **keep-K** sliding retention + a permanent ``keep_every`` ladder;
  * **exact resume**: params, optimizer moments, step and the data step
    (``meta``) are restored, so the continued run is bit-identical;
  * **integrity**: content checksum verified on load; partial/corrupt files
    are skipped and the previous step is used.

Format, byte for byte the reference's: ``sha256(blob).hexdigest() + "\\n" +
blob`` with ``blob = msgpack({"meta": ..., "arrays": [{"dtype", "shape",
"data"}, ...]})``, written and read by the port's own codec
(``checkpoint/_msgpack.py``): a reference checkpoint loads into the port
and a port checkpoint into the reference.  bf16 leaves carry the dtype
``"bfloat16"`` and their raw bits.  A bin holds at most 2^32 - 1 bytes, so
a leaf of 4 GiB or more cannot be saved in this format, as in the
reference: the save fails and ``wait()`` raises naming the step.

Leaves are listed as ``jax.tree_util`` lists them: dict values in sorted
key order, lists and tuples in order, ``None`` holding none; an object
with ``checkpoint_leaves()`` (the trainer's ``BSPTrainState``: the
reference's ``(params, mu, nu, ef, step)`` tuple) lists its own and is
rebuilt by its ``from_checkpoint_leaves``.  The reference stores jax's
``str(treedef)`` under ``meta["treedef"]``, which no loader reads; the
port stores a descriptor of its own there.
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

_STEP_RE = re.compile(r"^step_(\d+)\.ckpt$")


def _leaf_list(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_list(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaf_list(v)]
    return [tree]


def _descriptor(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_descriptor(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_descriptor(v) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _host_copy(leaf) -> torch.Tensor:
    """A host tensor holding ``leaf``'s value now (a copy, never a view of
    state the caller goes on to update)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf, copy=True))


def _flatten(tree) -> Tuple[List[torch.Tensor], str]:
    if hasattr(tree, "checkpoint_leaves"):
        return tree.checkpoint_leaves(), tree.checkpoint_descriptor()
    leaves = [_host_copy(x) for x in _leaf_list(tree)]
    return leaves, "repro_torch " + _descriptor(tree)


def _record(t: torch.Tensor) -> dict:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        name, arr = "bfloat16", t.view(torch.int16).numpy()
    else:
        arr = t.numpy()
        name = str(arr.dtype)
    return {"dtype": name, "shape": list(t.shape),
            "data": memoryview(arr.reshape(-1)).cast("B")}


def _from_record(rec: dict) -> torch.Tensor:
    shape, data = rec["shape"], rec["data"]
    if rec["dtype"] == "bfloat16":
        if not len(data):
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(data, dtype=torch.bfloat16).reshape(shape)
    arr = np.frombuffer(data, dtype=rec["dtype"]).reshape(shape)
    return torch.from_numpy(arr)


def _encode(leaves: List[torch.Tensor], meta: dict) -> List:
    """The file's pieces: the digest line, then the msgpack blob in
    pieces that hold the leaves' own buffers (nothing of many GB is
    joined)."""
    chunks = _msgpack.packb_chunks(
        {"meta": meta, "arrays": [_record(t) for t in leaves]})
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return [h.hexdigest().encode() + b"\n"] + chunks


def _deserialize(raw) -> Tuple[List[torch.Tensor], dict]:
    """Leaves (host tensors over ``raw``'s memory: pass a bytearray for
    writable ones) and meta; raises ``IOError`` on a checksum mismatch."""
    mv = memoryview(raw).cast("B")
    digest, blob = bytes(mv[:65]), mv[65:]      # 64 hex digits + "\n"
    if hashlib.sha256(blob).hexdigest().encode() + b"\n" != digest:
        raise IOError("checkpoint checksum mismatch")
    payload = _msgpack.unpackb(blob, bin_view=True)
    return [_from_record(a) for a in payload["arrays"]], payload["meta"]


def _read(path: Path) -> bytearray:
    buf = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise IOError(f"{path}: short read")
    return buf


def _cast_like(leaf: torch.Tensor, like):
    if isinstance(like, torch.Tensor):
        return leaf.to(dtype=like.dtype, device=like.device)
    if hasattr(like, "dtype"):
        return leaf.numpy().astype(like.dtype)
    return leaf.numpy()


def _unflatten(like, leaves: List) -> Any:
    it = iter(leaves)

    def rec(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            vals = [rec(v) for v in node]
            return tuple(vals) if isinstance(node, tuple) else vals
        return _cast_like(next(it), node)

    return rec(like)


def _count(like) -> int:
    if hasattr(like, "checkpoint_leaves"):
        return like.checkpoint_leaf_count()
    return len(_leaf_list(like))


@dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    keep_every: int = 0          # additionally keep every Nth step forever

    def __post_init__(self):
        self.dir = Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None
        self._errors: List[str] = []
        # one entry per finished save: step, file bytes, seconds of the
        # host copy (caller thread) and of the encode + write + fsync
        self.saves: List[dict] = []

    # ------------------------------------------------------------------ save

    def save(self, step: int, state, meta: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Snapshot ``state`` (device→host now, disk write async; a
        blocking save raises its error at once)."""
        t0 = time.perf_counter()
        leaves, treedef = _flatten(state)
        copy_s = time.perf_counter() - t0
        meta = dict(meta or {}, step=int(step), treedef=treedef,
                    time=time.time())

        def write():
            try:
                t1 = time.perf_counter()
                pieces = _encode(leaves, meta)
                tmp = self.dir / f"step_{step}.tmp-{os.getpid()}"
                with open(tmp, "wb") as f:
                    for p in pieces:
                        f.write(p)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.dir / f"step_{step}.ckpt")
                self.saves.append({
                    "step": int(step), "copy_s": copy_s,
                    "bytes": sum(memoryview(p).nbytes for p in pieces),
                    "write_s": time.perf_counter() - t1})
                self._gc()
            except Exception as e:   # surfaced by wait()
                self._errors.append(f"save {step}: {e}")

        self.wait()
        if blocking:
            write()
            self.wait()
        else:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._errors:
            errs, self._errors = self._errors, []
            raise IOError("; ".join(errs))

    # ------------------------------------------------------------------ load

    def steps(self) -> List[int]:
        out = []
        for p in self.dir.iterdir():
            m = _STEP_RE.match(p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like, step: Optional[int] = None):
        """Restore into the structure/dtypes (and devices) of ``like``,
        which stays as it is; skips corrupt files (falls back to the
        previous step).  Returns (state, meta) or None."""
        candidates = self.steps()
        if step is not None:
            candidates = [s for s in candidates if s == step]
        for s in reversed(candidates):
            try:
                leaves, meta = _deserialize(
                    _read(self.dir / f"step_{s}.ckpt"))
            except Exception:
                continue
            if len(leaves) != _count(like):
                continue
            if hasattr(like, "from_checkpoint_leaves"):
                return like.from_checkpoint_leaves(leaves), meta
            return _unflatten(like, leaves), meta
        return None

    # ------------------------------------------------------------------ gc

    def _gc(self) -> None:
        with self._lock:
            steps = self.steps()
            protected = {s for s in steps
                         if self.keep_every and s % self.keep_every == 0}
            victims = [s for s in steps if s not in protected][:-self.keep] \
                if self.keep else []
            for s in victims:
                try:
                    (self.dir / f"step_{s}.ckpt").unlink()
                except OSError:
                    pass
