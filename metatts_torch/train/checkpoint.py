"""Checkpoints in the JAX package's layout, with its surgery rules.

A checkpoint is a flax msgpack blob (``flax.serialization.to_bytes``) of
``{params, state, opt_state, step}``, where ``params`` and ``state`` are the
JAX FastSpeech2 trees of ``convert.jax_trees_from_fs2``.  Neither flax nor
msgpack is needed: ``to_bytes`` / ``msgpack_restore`` below write and read
the subset of msgpack that flax writes -- maps, arrays, str, bin, int,
float, nil and bool, ext type 1 (an ndarray as ``(shape, dtype name, C
bytes)``) and ext type 3 (a numpy scalar, packed as a 0-d ndarray).  Lists
and tuples are written as maps with string indices, as flax does.  A
``bfloat16`` leaf (numpy has no such dtype) is read as its raw uint16 bits
viewed as a ``torch.bfloat16`` tensor (a scalar as a 0-d tensor, which is
written back as a 0-d array).

Load-time surgery (the JAX package's ``train/checkpoint.py``, in turn the
reference's ``lightning/systems/system.py:115-192``):

* a 2-D table whose row count differs but whose second axis matches (the
  speaker table across corpora): copy the overlapping rows, keep the new
  init for the rest;
* any other shape mismatch: keep the fresh init and report it;
* a leaf missing from the checkpoint: keep the init and report it.

The report lines are the JAX package's, word for word.  The optimizer
state is ``NoamAdam.state_tree``'s: the tree flax makes of the JAX
package's optax chain, so either package resumes the other's checkpoints.
As in the JAX package it is dropped whenever surgery changed a leaf.
"""

import os
import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ---------------------------------------------------------------- writer

def _pack_len(out, n, small, small_max, codes):
    """Header of a str/bin/array/map of length n: a fix form below
    ``small_max`` (``small`` | n, None for bin), else 8/16/32-bit lengths."""
    if small is not None and n < small_max:
        out.append(small | n)
        return
    for code, fmt, limit in codes:
        if code is not None and n < limit:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack")


_STR = ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32))
_BIN = ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32))
_ARRAY = ((None, "", 0), (0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32))
_MAP = ((None, "", 0), (0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))


def _pack_int(out, v):
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xff)
    elif v >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < limit:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                 (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -limit:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out, code, data):
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, ((0xc7, ">B", 1 << 8), (0xc8, ">H", 1 << 16),
                                    (0xc9, ">I", 1 << 32)))
    out.append(code)
    out += data


def _ndarray_bytes(shape, dtype_name, buf):
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    out = bytearray()
    _pack_len(out, 3, 0x90, 16, _ARRAY)
    _pack_len(out, len(shape), 0x90, 16, _ARRAY)
    for d in shape:
        _pack_int(out, int(d))
    name = dtype_name.encode()
    _pack_len(out, len(name), 0xa0, 32, _STR)
    out += name
    _pack_len(out, len(buf), None, 0, _BIN)
    out += buf
    return bytes(out)


def _pack(out, x):
    if isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, _MAP)
        for k, v in x.items():
            _pack(out, str(k))
            _pack(out, v)
    elif isinstance(x, (list, tuple)):
        _pack(out, {str(i): v for i, v in enumerate(x)})
    elif isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            buf = t.view(torch.int16).numpy().tobytes()
            _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(t.shape, "bfloat16", buf))
        else:
            _pack(out, t.numpy())
    elif isinstance(x, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(
            x.shape, x.dtype.name, np.ascontiguousarray(x).tobytes()))
    elif isinstance(x, np.generic):
        a = np.asarray(x)
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(a.shape, a.dtype.name, a.tobytes()))
    elif x is None:
        out.append(0xc0)
    elif isinstance(x, bool):
        out.append(0xc3 if x else 0xc2)
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out += b"\xcb" + struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode()
        _pack_len(out, len(b), 0xa0, 32, _STR)
        out += b
    elif isinstance(x, (bytes, bytearray)):
        _pack_len(out, len(x), None, 0, _BIN)
        out += x
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def to_bytes(tree):
    """A tree of dicts, lists, numpy arrays and scalars, torch tensors and
    Python scalars -> flax-compatible msgpack bytes."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ---------------------------------------------------------------- reader

class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw=False):
        c = self.unpack(">B")
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f, raw)
        if 0x90 <= c <= 0x9f:
            return [self.value(raw) for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return self.str(c & 0x1f, raw)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
                0xca: ">f", 0xcb: ">d"}
        if c in ints:
            return self.unpack(ints[c])
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
                0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",
                0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if c in fixext or c in (0xc7, 0xc8, 0xc9):
            n = fixext[c] if c in fixext else self.unpack(lens[c])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if c in lens:
            n = self.unpack(lens[c])
            if c <= 0xc6:
                return bytes(self.take(n))
            if c <= 0xdb:
                return self.str(n, raw)
            if c <= 0xdd:
                return [self.value(raw) for _ in range(n)]
            return self.map(n, raw)
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def str(self, n, raw):
        b = bytes(self.take(n))
        return b if raw else b.decode()

    def map(self, n, raw):
        out = {}
        for _ in range(n):
            k = self.value(raw)
            out[k] = self.value(raw)
        return out


def _ext(code, data):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    r = _Reader(data)
    shape, name, buf = r.value(raw=True)
    shape = tuple(shape)
    if name == b"bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape)
        arr = torch.from_numpy(bits.copy()).view(torch.bfloat16)
        return arr if code == _EXT_NDARRAY else arr.reshape(())
    arr = np.frombuffer(buf, np.dtype(name.decode())).reshape(shape)
    return arr if code == _EXT_NDARRAY else arr[()]


def msgpack_restore(blob):
    """flax-msgpack bytes -> a tree of dicts (string keys), numpy arrays and
    scalars (bfloat16 leaves as torch tensors)."""
    r = _Reader(blob)
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


# ----------------------------------------------------------- checkpoints

def _host_array(x):
    """A checkpoint leaf as a numpy array (bfloat16 widened to fp32)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x)


def merge_with_surgery(like, raw, prefix=""):
    """``like`` (the model's own tree) filled from ``raw`` (a restored
    checkpoint tree) under the surgery rules -> (tree, report lines)."""
    report = []
    if isinstance(like, dict):
        out = {}
        raw = raw if isinstance(raw, dict) else {}
        for k, v in like.items():
            out[k], rep = merge_with_surgery(v, raw.get(k, raw.get(str(k))),
                                             f"{prefix}/{k}")
            report += rep
        return out, report
    if isinstance(like, (list, tuple)):
        out = []
        for i, v in enumerate(like):
            rk = None
            if isinstance(raw, (list, tuple)) and i < len(raw):
                rk = raw[i]
            elif isinstance(raw, dict):
                rk = raw.get(str(i), raw.get(i))
            merged, rep = merge_with_surgery(v, rk, f"{prefix}/{i}")
            out.append(merged)
            report += rep
        return type(like)(out), report
    if raw is None:
        report.append(f"missing {prefix}: kept init")
        return like, report
    raw = _host_array(raw)
    like = np.asarray(like)
    if raw.shape == like.shape:
        return raw.astype(like.dtype), report
    if raw.ndim == like.ndim == 2 and raw.shape[1] == like.shape[1]:
        out = np.array(like)
        n = min(raw.shape[0], like.shape[0])
        out[:n] = raw[:n]
        report.append(f"resized {prefix}: {raw.shape} -> {like.shape} "
                      f"(copied {n} rows)")
        return out, report
    report.append(f"shape mismatch {prefix}: {raw.shape} vs "
                  f"{like.shape}, kept init")
    return like, report


def save_checkpoint(path, model, step, optimizer=None):
    """Write ``model``'s parameters and BatchNorm statistics at ``step`` as
    the JAX package's checkpoint (``params``, ``state``, ``opt_state``,
    ``step``), through a temporary file and a rename.  ``opt_state`` is
    ``optimizer.state_tree(model)``, or empty without an optimizer."""
    from ..convert import jax_trees_from_fs2
    params, state = jax_trees_from_fs2(model)
    opt_state = {} if optimizer is None else optimizer.state_tree(model)
    blob = to_bytes({"params": params, "state": state, "opt_state": opt_state,
                     "step": np.asarray(step, np.int64)})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


NO_OPT_STATE = "no optimizer state in the checkpoint: the optimizer starts afresh"


def load_checkpoint(path, model):
    """Load a checkpoint of either package into ``model`` (in place) under
    the surgery rules.  Returns (opt_state, step, report lines):
    ``opt_state`` is the checkpoint's optimizer tree (for
    ``NoamAdam.load_state_tree``), or None where surgery changed a leaf (the
    JAX package's rule) or the checkpoint holds none (an empty tree, as
    checkpoints written without an optimizer have; a report line says so)."""
    from ..convert import jax_trees_from_fs2, load_fs2_from_jax
    with open(path, "rb") as f:
        raw = msgpack_restore(f.read())
    like_params, like_state = jax_trees_from_fs2(model)
    params, report = merge_with_surgery(like_params, raw.get("params", {}))
    state, srep = merge_with_surgery(like_state, raw.get("state", {}))
    report += srep
    load_fs2_from_jax(model, params, state)
    step = int(np.asarray(_host_array(raw.get("step", 0))))
    opt_state = None if report else raw.get("opt_state") or None
    if not report and opt_state is None:
        report.append(NO_OPT_STATE)
    return opt_state, step, report


@torch.no_grad()
def average_speaker_rows(model, train_rows):
    """avg_train_spk_emb: every row of ``model``'s speaker table becomes the
    mean of the training speakers' rows (reference ``system.py:195-213``)."""
    table = model.speaker_emb.model.weight
    mean = table[torch.as_tensor(list(train_rows), device=table.device)].mean(
        0, keepdim=True)
    table.copy_(mean.expand_as(table))
