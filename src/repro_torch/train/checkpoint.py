"""Checkpoints: atomic, asynchronous, in the JAX package's format (the
counterpart of ``repro/train/checkpoint.py``).

One directory per step (``step_00001234/``) holds ``arrays.npz`` (one
array per state leaf) and ``meta.json`` (the step, the controller's JSON,
the rules fingerprint, the per-leaf group map, the rank overrides). A save
copies the state to the host at once and writes it on a thread into
``<dir>.tmp``, published by an atomic ``os.rename``; ``wait()`` joins the
thread. :func:`check_rules_compat` refuses a restore under other
param-group rules, or of rank-shrunk state into a run without rank
adaptation.

The port writes the reference's key strings, those of
``jax.tree_util.keystr`` over its ``TrainState``: ``.params['head']``,
``.params['head'][<flat index 0>]`` for a QTensor's codes (1: scales,
2: zero points when asymmetric), ``.opt.inner['head'].m[<flat index 0>]``,
``.opt.proj['head'][<flat index 0>]`` and ``.opt.count``. So a directory
either package wrote restores into the other; restoring a directory the
JAX package's ``Trainer`` wrote is the state counterpart of
``serve.params.from_jax_params``. A restore fills a template state (the
QTensor layouts, on the ``meta`` device: :func:`step.abstract_state`) and
checks every shape. bfloat16 leaves are written as float32 (numpy has no
bfloat16) and cast back on restore.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.adam8bit import Adam8bitState
from repro_torch.core.qgalore import QGaLoreState, flatten, keystr, unflatten
from repro_torch.core.quant import QTensor

_STEP_RE = re.compile(r"^step_(\d{8})$")


def check_rules_compat(meta: Dict, fingerprint: str,
                       groups: Optional[Dict[str, str]] = None,
                       adaptive_rank: Optional[bool] = None) -> None:
    """Refuse a checkpoint written under other param-group rules, or one
    holding rank-shrunk state when this run has rank adaptation off.
    Checkpoints without a fingerprint predate the rules and pass."""
    shrunk = meta.get("rank_overrides") or {}
    if shrunk and adaptive_rank is False:
        ov = sorted(shrunk.items())[:8]
        raise ValueError(
            "checkpoint holds rank-shrunk optimizer state "
            f"(rank_overrides={ov}) but this run has adaptive_rank "
            "disabled: it cannot adopt the shrunk low-rank moments and "
            "projections. Enable QGaLoreConfig.adaptive_rank, or restore "
            "a checkpoint from before the transition.")
    saved = meta.get("rules_fingerprint")
    if saved is None or saved == fingerprint:
        return
    saved_groups = meta.get("groups") or {}
    changed = sorted(p for p in set(saved_groups) | set(groups or {})
                     if saved_groups.get(p) != (groups or {}).get(p))[:8]
    raise ValueError(
        "checkpoint was written under different param-group rules "
        f"(saved fingerprint {saved}, current {fingerprint}; first "
        f"differing leaves: {changed}). Restore with the original rules "
        "or start fresh state.")


# ---------------------------------------------------------------------------
# The state as (key, tensor) pairs in the reference's order
# ---------------------------------------------------------------------------

def _leaf_items(prefix: str, leaf) -> Iterator[Tuple[str, torch.Tensor]]:
    if leaf is None:
        return
    if isinstance(leaf, QTensor):
        parts = [leaf.q, leaf.scale] + ([] if leaf.zero is None
                                        else [leaf.zero])
        for i, t in enumerate(parts):
            yield f"{prefix}[<flat index {i}>]", t
    else:
        yield prefix, leaf


def state_items(state) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every array of a ``TrainState`` with its key string; the step
    count as a 0-d int32 tensor under ``.opt.count``."""
    params, opt = state
    flat = flatten(params)
    for keys, leaf in flat:
        yield from _leaf_items(".params" + keystr(keys), leaf)
    for (keys, _), inner in zip(flat, opt.inner):
        if inner is not None:
            yield from _leaf_items(".opt.inner" + keystr(keys) + ".m",
                                   inner.m)
            yield from _leaf_items(".opt.inner" + keystr(keys) + ".v",
                                   inner.v)
    for (keys, _), P in zip(flat, opt.proj):
        yield from _leaf_items(".opt.proj" + keystr(keys), P)
    yield ".opt.count", torch.tensor(int(opt.count), dtype=torch.int32)


def state_tensors(state) -> Iterator[torch.Tensor]:
    """Every tensor of a ``TrainState`` (as stored, on its device)."""
    for key, t in state_items(state):
        if key != ".opt.count":
            yield t


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def state_arrays(state) -> Dict[str, np.ndarray]:
    """The state on the host, keyed as the reference keys it."""
    return {k: _host(t) for k, t in state_items(state)}


def restore_into(template, arrays: Dict[str, np.ndarray], device):
    """A ``TrainState`` shaped like ``template`` (any device, ``meta``
    included) holding ``arrays``, on ``device``. Every key of the
    template must be present with the template's shape."""
    def get(key: str, like: torch.Tensor) -> torch.Tensor:
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs expected {tuple(like.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=device,
                                                  dtype=like.dtype)

    def leaf(prefix: str, like):
        if like is None:
            return None
        if isinstance(like, QTensor):
            parts = [like.q, like.scale] + ([] if like.zero is None
                                            else [like.zero])
            got = [get(f"{prefix}[<flat index {i}>]", t)
                   for i, t in enumerate(parts)]
            return QTensor(got[0], got[1], got[2] if len(got) > 2 else None,
                           like.bits, like.block, like.orig_last, like.dtype)
        return get(prefix, like)

    params, opt = template
    flat = flatten(params)
    keys = [k for k, _ in flat]
    new_params = unflatten(keys, [leaf(".params" + keystr(k), l)
                                  for k, l in flat])
    inner = [None if i is None else Adam8bitState(
        leaf(".opt.inner" + keystr(k) + ".m", i.m),
        leaf(".opt.inner" + keystr(k) + ".v", i.v))
        for k, i in zip(keys, opt.inner)]
    proj = [leaf(".opt.proj" + keystr(k), P) for k, P in zip(keys, opt.proj)]
    if ".opt.count" not in arrays:
        raise KeyError("checkpoint missing leaf .opt.count")
    count = int(np.asarray(arrays[".opt.count"]))
    return type(template)(new_params, QGaLoreState(inner, proj, count))


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- introspection ------------------------------------------------------
    def all_steps(self):
        return sorted(int(m.group(1)) for m in map(_STEP_RE.match,
                                                   os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, extra_meta: Optional[Dict] = None):
        """Copy ``state`` to the host now; write it (on a thread when
        ``async_save``)."""
        self.wait()
        arrays = state_arrays(state)
        meta = {"step": step, **(extra_meta or {})}

        def work():
            final = self._path(step)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                  # atomic publish
            self._gc()

        if not self.async_save:
            work()
            return

        def guarded():
            try:
                work()
            except BaseException as e:             # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=guarded, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def read_meta(self, step: Optional[int] = None) -> Dict:
        """``meta.json`` of ``step`` (default: the latest), without the
        arrays."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with open(os.path.join(self._path(step), "meta.json")) as f:
            return json.load(f)

    def restore(self, step: Optional[int], template, device):
        """``(state, meta)`` of ``step`` (default: the latest), shaped like
        ``template``, on ``device``."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return restore_into(template, arrays, device), meta
