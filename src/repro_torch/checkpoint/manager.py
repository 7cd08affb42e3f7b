"""Fault-tolerant checkpointing: atomic, step-tagged, async-capable,
retention-managed, torn-write-detecting.

Layout:  <dir>/step_<N>/{manifest.json, arrays.npz}
Atomicity: written to ``<dir>/.tmp_<N>`` then ``os.replace``d, so a
crash mid-save never corrupts the latest checkpoint (a restart picks
the newest complete step). ``data_state`` (the caller's cursor) travels
with the state, so restarts are exactly-once over the schedule.

The on-disk format is the reference package's: a state is a nested
dict or NamedTuple (an LM training state in the reference's layout,
`repro_torch.train.state_tree`) whose leaves are tensors or arrays;
each leaf is stored under the key the reference derives with
``jax.tree_util.keystr`` (dict keys sorted, ``"['sink']['labels_hubs']"``;
NamedTuple fields in order, ``".opt.mu['embed']['tok']"``), in the same
order, so either package resumes from the other's steps.

- Tensors are copied to host numpy arrays in :meth:`CheckpointManager.save`,
  before the writer thread starts: the thread never touches a device
  tensor, and a tensor the caller updates in place after ``save``
  returns cannot tear the step being written.
- :meth:`CheckpointManager.restore` puts each array back on the device
  and in the dtype of the matching leaf of the caller's template (a
  template leaf on the ``meta`` device gives a host tensor).
- A **torn or corrupt step** (truncated or bit-flipped ``arrays.npz``,
  unparseable manifest) is detected: restores and peeks with
  ``step=None`` fall back to the newest intact step (each skip warns),
  and an explicitly requested corrupt step raises
  :class:`CorruptCheckpointError`.
- Retention GC cannot delete a step out from under a concurrent
  ``restore``/``peek`` (the writer thread runs ``_gc`` after every
  save): steps being read are pinned.
- The write path runs inside bounded retry-with-backoff
  (``repro_torch.ft.inject.with_retries``) and passes the
  ``checkpoint.write`` and ``checkpoint.commit`` fault sites.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ft.inject import fault_site, with_retries


class CorruptCheckpointError(RuntimeError):
    """A checkpoint step exists on disk but cannot be trusted (torn
    write, truncated archive, bit rot, unparseable manifest)."""

    def __init__(self, step: Optional[int], path: str, reason: str):
        super().__init__(
            f"checkpoint step {step} at {path} is corrupt: {reason}")
        self.step = step
        self.path = path
        self.reason = reason


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs of a state of nested dicts and NamedTuples,
    keyed and ordered as ``jax.tree_util.keystr`` over
    ``tree_flatten_with_path`` does: dict keys sorted and spelled
    ``[repr(key)]``, NamedTuple fields in their order and spelled
    ``.field``; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten(getattr(tree, f), f"{prefix}.{f}")]
    return [(prefix, tree)]


def _unflatten(tree: Any, leaves) -> Any:
    """``tree`` with its leaves replaced, in :func:`flatten` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    return next(leaves)


def _host_copy(v) -> np.ndarray:
    """A host numpy copy of a leaf that nothing else references.
    Dtypes numpy lacks (bf16) and half floats are stored as their exact
    f32 upcast, as the reference stores them; restore casts back."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype in (torch.bfloat16, torch.float16):
            v = v.float()
        return v.to("cpu", copy=True).numpy()
    a = np.array(v)
    return a.astype(np.float32) if a.dtype == np.float16 else a


def _like(a: np.ndarray, tmpl):
    """``a`` in the dtype of template leaf ``tmpl``, on its device when
    it is a tensor (on the host when that device is ``meta``)."""
    if isinstance(tmpl, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(a))
        dev = "cpu" if tmpl.device.type == "meta" else tmpl.device
        return t.to(device=dev, dtype=tmpl.dtype)
    if hasattr(tmpl, "dtype") and a.dtype != tmpl.dtype:
        return a.astype(tmpl.dtype)
    return a


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._reading: set = set()       # steps pinned against GC
        self._verified: Dict[int, Optional[str]] = {}   # step -> reason
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    # ------------------------------------------------------------ save

    def save(self, step: int, state: Any,
             data_state: Optional[Dict] = None,
             blocking: bool = True) -> None:
        """Commit ``state`` as step ``step``. With ``blocking=False``
        the write runs on a writer thread; at most one save is ever in
        flight (this call first waits for the previous one)."""
        self.wait()
        host = [(k, _host_copy(v)) for k, v in flatten(state)]
        if blocking:
            self._write(step, host, data_state)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, data_state))
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host, data_state) -> None:
        tmp = os.path.join(self.dir, f".tmp_{step}")
        final = self._step_dir(step)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        arrays_path = os.path.join(tmp, "arrays.npz")

        def write_payload() -> None:
            np.savez(arrays_path, **dict(host))
            fault_site("checkpoint.write", path=arrays_path)
            manifest = {
                "step": step,
                "keys": [k for k, _ in host],
                "data_state": data_state or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)

        with_retries(write_payload, describe=f"checkpoint step {step}")
        fault_site("checkpoint.commit", path=arrays_path)
        shutil.rmtree(final, ignore_errors=True)
        with self._lock:
            self._verified.pop(step, None)
        os.replace(tmp, final)
        self._gc()

    def clear(self) -> None:
        """Drop every committed step (e.g. before a build whose state
        differs: stale steps would outrank the new run's lower step
        numbers in retention GC)."""
        self.wait()
        for s in self.all_steps():
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        with self._lock:
            self._verified.clear()

    def _gc(self) -> None:
        steps = self.all_steps()
        doomed = steps[:-self.keep] if self.keep else []
        with self._lock:
            # never delete a step a concurrent restore/peek is reading
            doomed = [s for s in doomed if s not in self._reading]
            for s in doomed:
                self._verified.pop(s, None)
        for s in doomed:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # --------------------------------------------------------- verify

    def verify_step(self, step: int) -> Optional[str]:
        """``None`` when the step looks intact, else the reason it is
        not. Reads the whole archive (zip CRCs catch truncation and bit
        flips); results are cached, since committed steps are
        immutable."""
        with self._lock:
            if step in self._verified:
                return self._verified[step]
        path = self._step_dir(step)
        reason = None
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            if manifest.get("step") != step:
                reason = (f"manifest names step {manifest.get('step')}"
                          f", directory names {step}")
            else:
                with zipfile.ZipFile(
                        os.path.join(path, "arrays.npz")) as zf:
                    bad = zf.testzip()
                    if bad is not None:
                        reason = f"arrays.npz member {bad!r} fails CRC"
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile, json.JSONDecodeError) as e:
            reason = f"{type(e).__name__}: {e}"
        with self._lock:
            self._verified[step] = reason
        return reason

    def _resolve_step(self, step: Optional[int]) -> int:
        """An explicit ``step`` verified (corrupt: a typed raise);
        ``None``: the newest intact step, warning per skipped one."""
        if step is not None:
            reason = self.verify_step(step)
            if reason is not None:
                raise CorruptCheckpointError(step, self._step_dir(step),
                                             reason)
            return step
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        for s in reversed(steps):
            reason = self.verify_step(s)
            if reason is None:
                return s
            warnings.warn(
                f"skipping corrupt checkpoint step {s} "
                f"({reason}); falling back to the previous step",
                stacklevel=3)
        raise CorruptCheckpointError(
            steps[-1], self.dir,
            "no intact step remains (all candidates fail verification)")

    # --------------------------------------------------------- restore

    def all_steps(self) -> List[int]:
        return sorted(int(name.split("_")[1])
                      for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_intact_step(self) -> Optional[int]:
        """The newest step that passes verification (None when the
        directory holds no step); torn or corrupt steps are skipped
        with a warning, not deleted."""
        if not self.all_steps():
            return None
        return self._resolve_step(None)

    def peek(self, step: Optional[int] = None) -> Dict:
        """The ``data_state`` of a committed step without loading its
        arrays (resume decides from it whether a restore is worth
        doing). ``step=None``: the newest intact step."""
        step = self._resolve_step(step)
        with self._lock:
            self._reading.add(step)
        try:
            with open(os.path.join(self._step_dir(step),
                                   "manifest.json")) as f:
                return json.load(f).get("data_state", {})
        finally:
            with self._lock:
                self._reading.discard(step)

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, int, Dict]:
        """Restore into the structure of ``template``: each array goes
        to the device and dtype of its template leaf (a numpy leaf
        gives a numpy array). Returns ``(state, step, data_state)``.
        ``step=None`` restores the newest intact step; a corrupt
        explicit ``step`` raises :class:`CorruptCheckpointError`."""
        step = self._resolve_step(step)
        path = self._step_dir(step)
        with self._lock:
            self._reading.add(step)
        try:
            try:
                with open(os.path.join(path, "manifest.json")) as f:
                    manifest = json.load(f)
                with np.load(os.path.join(path, "arrays.npz")) as arrs:
                    leaves = [_like(arrs[key], tmpl)
                              for key, tmpl in flatten(template)]
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile, json.JSONDecodeError) as e:
                # verification passed but the read failed anyway
                # (e.g. a template key the archive never held)
                raise CorruptCheckpointError(
                    step, path, f"{type(e).__name__}: {e}") from e
            state = _unflatten(template, iter(leaves))
            return state, manifest["step"], manifest.get("data_state", {})
        finally:
            with self._lock:
                self._reading.discard(step)
