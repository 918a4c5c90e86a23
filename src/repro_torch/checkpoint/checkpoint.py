"""Atomic, async checkpoints of nested numpy arrays and tensors.

Layout (the reference package's ``repro/checkpoint``, byte for byte, so
a checkpoint written by either package loads in the other)::

    <dir>/step_000123/
        manifest.json        tree paths + leaf metadata (+ optional extra)
        leaf_00000.npy ...   one file per leaf, on the host
    <dir>/LATEST             committed step pointer (atomic replace)

Guarantees:
  * atomic commit: data written to ``step_X.tmp`` then renamed, LATEST
    updated last — a crash mid-write can never corrupt a committed step;
  * durable commit: every leaf file, the manifest, and the directory
    entries are fsync'd before the rename, and the rename itself is made
    durable before LATEST moves — the pointer can never lead a committed
    step to disk;
  * async: writes happen on daemon threads that commit one at a time,
    in the order the saves were issued (each joins the one before it);
    ``LATEST`` only moves forward, through a temporary pointer file no
    other writer shares.  ``wait_for_writes`` joins them (registered via
    atexit so interpreter exit can't drop a write), and a writer's
    exception is re-raised there and by the next ``save_checkpoint``;
  * crash-tolerant discovery: ``latest_step`` treats LATEST as the
    commit point when it is readable and points at a real manifest, and
    otherwise falls back to scanning ``step_*`` dirs — uncommitted
    ``.tmp`` dirs and torn pointers are skipped, never trusted.

Trees are nested dicts, lists and tuples (and named tuples) of numpy
arrays or tensors; None is an empty subtree.  Leaf paths are spelled as
the reference spells them: ``['key']`` for a dict key (``repr`` of the
key, keys in sorted order), ``[0]`` for a sequence index, ``.name`` for
a named-tuple field, joined with ``/``.  bfloat16 and float8 leaves,
which numpy cannot hold, are stored as raw unsigned views with their
true dtype in the manifest and read back as torch tensors of that dtype.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

_LOCK = threading.Lock()
_TAIL: list = []  # the newest async writer, if any
_ERRORS: list = []  # exceptions of async writers, not yet re-raised


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree):
    """(paths, leaves) of ``tree`` in the reference's order and spelling.
    The walk is a module function, not a closure over the output lists: a
    recursive closure is a reference cycle, which would keep the leaves
    (a step's gradients) alive until the cyclic collector runs."""
    paths, leaves = [], []
    _walk(tree, (), paths, leaves)
    return paths, leaves


def _walk(node, prefix, paths, leaves) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for key in sorted(node):
            _walk(node[key], prefix + (f"[{key!r}]",), paths, leaves)
    elif _is_namedtuple(node):
        for name, child in zip(node._fields, node):
            _walk(child, prefix + (f".{name}",), paths, leaves)
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            _walk(child, prefix + (f"[{i}]",), paths, leaves)
    else:
        paths.append("/".join(prefix))
        leaves.append(node)


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in flatten order
    (a module function for the reason :func:`_flatten_with_paths` gives)."""
    return _build(like, iter(leaves))


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        out = {key: _build(node[key], it) for key in sorted(node)}
        return {key: out[key] for key in node}
    if _is_namedtuple(node):
        return type(node)(*(_build(child, it) for child in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(child, it) for child in node)
    return next(it)


# str(DictKey('x')) renders as "['x']"; strip the decoration so flat-dict
# checkpoints can be read back by plain key without a like-tree.
_DICTKEY_RE = re.compile(r"^\['(.*)'\]$")


def _norm_key(path: str) -> str:
    m = _DICTKEY_RE.match(path)
    return m.group(1) if m else path


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Make directory entries (new files, renames) durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# numpy cannot hold bfloat16 or float8: they are stored as raw unsigned
# views, with the true dtype in the manifest (the reference's layout).
_RAW_VIEW = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
             "float8_e5m2": np.uint8}
_SIGNED = {np.uint16: (np.int16, torch.int16), np.uint8: (np.uint8, torch.uint8)}


def _to_native(leaf):
    """(host numpy array, true dtype name) of a numpy array or tensor."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if name in _RAW_VIEW:
            raw = _RAW_VIEW[name]
            return t.view(_SIGNED[raw][1]).numpy().view(raw), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name in _RAW_VIEW:  # an ml_dtypes array handed in by a caller
        return arr.view(_RAW_VIEW[name]), name
    return arr, name


def _from_native(arr: np.ndarray, dtype_name: str):
    """A stored leaf back at its true dtype: a numpy array, or a torch
    tensor for the dtypes numpy cannot hold."""
    if dtype_name in _RAW_VIEW:
        np_view, t_view = _SIGNED[_RAW_VIEW[dtype_name]]
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np_view).copy())
        return t.view(t_view).view(getattr(torch, dtype_name))
    return arr.astype(dtype_name)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    async_write: bool = False,
                    extra: Optional[dict] = None) -> str:
    """Write one checkpoint; returns the committed directory path.

    ``extra`` is an optional JSON-serializable dict stored verbatim in
    the manifest — for small non-array metadata (strings, version tags)
    that has no business being an npy leaf.
    """
    paths, leaves = _flatten_with_paths(tree)
    host_leaves = [_to_native(leaf) for leaf in leaves]

    def _write():
        final = _step_dir(ckpt_dir, step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):  # stale debris from a crashed writer
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        if extra is not None:
            manifest["extra"] = extra
        for i, (p, (raw, dtype_name)) in enumerate(zip(paths, host_leaves)):
            fname = f"leaf_{i:05d}.npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, raw)
                _fsync_file(f)
            manifest["leaves"].append(
                {"path": p, "file": fname, "shape": list(raw.shape),
                 "dtype": dtype_name})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            _fsync_file(f)
        _fsync_dir(tmp)  # directory entries durable before the rename
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        _fsync_dir(ckpt_dir)  # the rename itself durable before LATEST
        current = latest_step(ckpt_dir)
        if current is None or current <= step:  # LATEST only moves forward
            fd, latest_tmp = tempfile.mkstemp(prefix="LATEST.", suffix=".tmp",
                                              dir=ckpt_dir)
            with os.fdopen(fd, "w") as f:
                f.write(str(step))
                _fsync_file(f)
            os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
            _fsync_dir(ckpt_dir)
        return final

    _raise_stored()
    if not async_write:
        wait_for_writes()  # commits stay in the order they were issued
        return _write()
    with _LOCK:
        prev = _TAIL[0] if _TAIL else None
        t = threading.Thread(target=_after, args=(prev, _write), daemon=True)
        _TAIL[:] = [t]
        t.start()
    return _step_dir(ckpt_dir, step)


def _after(prev, write) -> None:
    """An async writer: wait for the one issued before it, then write;
    an exception is stored for :func:`wait_for_writes` to re-raise."""
    if prev is not None:
        prev.join()
    try:
        write()
    except Exception as err:  # noqa: BLE001 — a thread's boundary: kept
        with _LOCK:
            _ERRORS.append(err)


def _raise_stored() -> None:
    """Re-raise the first stored writer exception (all are cleared)."""
    with _LOCK:
        errors = list(_ERRORS)
        _ERRORS.clear()
    if errors:
        raise errors[0]


def wait_for_writes():
    """Join every async writer issued so far; re-raise a writer's
    exception."""
    with _LOCK:
        tail = _TAIL[0] if _TAIL else None
    if tail is not None:
        tail.join()  # each writer joined the one before it
        with _LOCK:
            if _TAIL and _TAIL[0] is tail:
                _TAIL.clear()
    _raise_stored()


# a daemon writer thread dies with the interpreter mid-write; joining at
# exit turns "usually committed" into "committed".
atexit.register(wait_for_writes)


def committed_steps(ckpt_dir: str) -> list[int]:
    """All fully-renamed steps on disk, ascending.  A step counts only if
    its directory survived the atomic rename (no ``.tmp`` suffix) AND its
    manifest exists — a partially-copied dir is not a checkpoint."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        try:
            s = int(name[len("step_"):])
        except ValueError:
            continue
        if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(s)
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest committed step, or None.

    LATEST is the commit point when it is intact: readable, an int, and
    pointing at a directory with a manifest.  A torn or dangling pointer
    falls back to scanning the committed ``step_*`` dirs — never
    crashes, never returns an uncommitted ``.tmp``."""
    p = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(p):
        try:
            with open(p) as f:
                s = int(f.read().strip())
        except (OSError, ValueError):
            s = None
        if s is not None and os.path.exists(
                os.path.join(_step_dir(ckpt_dir, s), "manifest.json")):
            return s
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, step: int, like: Any) -> Any:
    """Load into the structure of ``like``: each leaf on the host, at
    the type of ``like``'s leaf (a tensor for a tensor, a numpy array at
    its dtype for an array)."""
    wait_for_writes()
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    paths, leaves = _flatten_with_paths(like)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for p, leaf in zip(paths, leaves):
        e = by_path[p]
        arr = _from_native(np.load(os.path.join(d, e["file"])), e["dtype"])
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(
                f"leaf {p}: checkpoint shape {tuple(arr.shape)} != model "
                f"{tuple(want)}")
        if isinstance(leaf, torch.Tensor):
            out.append(torch.as_tensor(arr).to(leaf.dtype))
        elif isinstance(arr, np.ndarray) and arr.dtype != np.asarray(leaf).dtype:
            out.append(arr.astype(np.asarray(leaf).dtype))
        else:
            out.append(arr)
    return _unflatten(like, out)


def load_checkpoint_items(
        ckpt_dir: str, step: Optional[int] = None,
) -> tuple[dict, Optional[dict], int]:
    """Dynamic loader: ``(items, extra, step)`` with no like-tree.

    ``items`` maps normalized leaf paths (dict-key decoration stripped)
    to host arrays at their *checkpointed* shapes (numpy arrays, torch
    tensors for bfloat16 / float8) — the reader decides what to do with
    them.  This is what a fresh process uses: it has no live tree whose
    capacities match the checkpoint's."""
    wait_for_writes()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {ckpt_dir!r}")
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    items = {}
    for e in manifest["leaves"]:
        arr = _from_native(np.load(os.path.join(d, e["file"])), e["dtype"])
        items[_norm_key(e["path"])] = arr
    return items, manifest.get("extra"), step


def restore_sharded(ckpt_dir: str, step: int, like: Any,
                    shardings: Any = None, device=None) -> Any:
    """Elastic restore: the leaves of ``like``'s structure as tensors on
    devices — ``shardings`` (a tree like ``like`` whose leaves are
    devices) names each leaf's device; without it every leaf goes to the
    CUDA card unless ``device`` names another.  The leaves are read at
    their checkpointed shapes, so a restart may place them anew."""
    from ..core.index import resolve_device

    host = load_checkpoint(ckpt_dir, step, like)
    _, leaves = _flatten_with_paths(host)
    if shardings is None:
        dev = resolve_device(device)
        targets = [dev] * len(leaves)
    else:
        targets = [torch.device(d) for d in _flatten_with_paths(shardings)[1]]
        if len(targets) != len(leaves):
            raise ValueError(f"{len(targets)} shardings for {len(leaves)} "
                             "leaves")
    return _unflatten(like, [torch.as_tensor(x).to(d)
                             for x, d in zip(leaves, targets)])
