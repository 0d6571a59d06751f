"""Checkpointing: msgpack-serialized trees of arrays, counterpart of
``repro.checkpoint.checkpoint`` in the same file format, so that either
package loads the other's files.

Format: a flat map {"/"-joined key path: {dtype, shape, data(bytes)}},
dict keys sorted, lists and tuples marked by a ``<path>/__seq__`` entry
("list" / "tuple") and their items keyed ``0000``, ``0001``, ... The leaf
maps' keys are bytes (b"dtype", b"shape", b"data"), as the reference writes
them. Leaves may be torch tensors (on any device), numpy arrays or Python
scalars; a bf16 leaf is written as dtype "bfloat16" with its bits as
16-bit integers (numpy has no bfloat16 of its own). Writes are atomic:
a temporary file in the target directory, ``fsync``, then ``os.replace``.

The port carries its own msgpack codec for the subset this format uses
(maps, str, bin, non-negative ints and arrays of them): it writes the
bytes ``msgpack.packb(flat, use_bin_type=True)`` writes, and reads keys
packed as str or as bin.
"""
from __future__ import annotations

import os
import struct
import tempfile
from typing import Any

import numpy as np
import torch

# ------------------------------------------------------------------ codec


def _header(n: int, fix: int, fix_max: int, wide: tuple[int, ...]) -> bytes:
    """A length header: the fix form for n <= fix_max, else the first of
    ``wide`` (8-, 16-, 32-bit length codes, ``0`` where a width is
    missing) whose width holds n."""
    if n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(wide, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit a msgpack header")


def _pack(obj, out: list) -> None:
    if isinstance(obj, bool) or obj is None or isinstance(obj, float):
        raise TypeError(f"checkpoint codec: unsupported value {obj!r}")
    if isinstance(obj, int):
        if obj < 0:
            raise TypeError(f"checkpoint codec: negative int {obj}")
        if obj < 0x80:
            out.append(bytes([obj]))
        else:
            for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                   (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
                if obj <= top:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    break
            else:
                raise TypeError(f"checkpoint codec: int {obj} exceeds 64 bits")
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_header(len(obj), 0, -1, (0xC4, 0xC5, 0xC6)))
        out.append(bytes(obj))
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 15, (0, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 15, (0, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"checkpoint codec: unsupported type {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for maps, str, bytes,
    non-negative ints and lists / tuples of them."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_WIDTH = {0: (">B", 1), 1: (">H", 2), 2: (">I", 4), 3: (">Q", 8)}


def unpackb(data: bytes):
    """Decode what :func:`packb` (or ``msgpack.packb`` over the same subset)
    wrote: str as str, bin as bytes."""
    view = memoryview(data)
    pos = 0

    def length(code_base: int, b: int) -> int:
        nonlocal pos
        fmt, w = _WIDTH[b - code_base]
        (n,) = struct.unpack_from(fmt, view, pos)
        pos += w
        return n

    def take(n: int) -> memoryview:
        nonlocal pos
        if pos + n > len(view):
            raise ValueError("checkpoint codec: truncated data")
        chunk = view[pos:pos + n]
        pos += n
        return chunk

    def read():
        nonlocal pos
        b = view[pos]
        pos += 1
        if b < 0x80:
            return b
        if 0x80 <= b <= 0x8F:
            return read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(take(b & 0x1F), "utf-8")
        if 0xCC <= b <= 0xCF:
            return length(0xCC, b)
        if 0xD9 <= b <= 0xDB:
            return str(take(length(0xD9, b)), "utf-8")
        if 0xC4 <= b <= 0xC6:
            return bytes(take(length(0xC4, b)))
        if b in (0xDC, 0xDD):
            return [read() for _ in range(length(0xDB, b))]
        if b in (0xDE, 0xDF):
            return read_map(length(0xDD, b))
        raise ValueError(f"checkpoint codec: unsupported type byte {b:#04x}")

    def read_map(n: int) -> dict:
        out = {}
        for _ in range(n):
            k = read()
            out[k] = read()
        return out

    obj = read()
    if pos != len(view):
        raise ValueError("checkpoint codec: trailing data")
    return obj


# --------------------------------------------------------------- the tree


def _leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {b"dtype": "bfloat16", b"shape": list(t.shape),
                    b"data": t.view(torch.int16).numpy().tobytes()}
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    dtype = "bfloat16" if arr.dtype.name == "bfloat16" else arr.dtype.str
    return {b"dtype": dtype, b"shape": [int(n) for n in arr.shape],
            b"data": arr.tobytes()}


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}/__seq__"] = "list" if isinstance(tree, list) else "tuple"
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i:04d}"))
    else:
        out[prefix] = _leaf(tree)
    return out


def save_pytree(path: str, tree: Any) -> None:
    """Crash-safe atomic write: serialize to a temp file in the target
    directory, fsync, then ``os.replace`` into place. An interrupted save
    (mid-write failure, kill, full disk) never leaves a truncated
    checkpoint at ``path``: the old file survives untouched and the temp
    file is removed."""
    payload = packb(_flatten(tree))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _array(val: dict):
    """A leaf map -> numpy array, or a CPU torch tensor for bf16."""
    dt = val.get("dtype", val.get(b"dtype"))
    shape = val.get("shape", val.get(b"shape"))
    data = val.get("data", val.get(b"data"))
    if dt == "bfloat16":
        bits = np.frombuffer(data, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(data, np.dtype(dt)).reshape(shape).copy()


def load_pytree(path: str) -> Any:
    """The tree :func:`save_pytree` (or the reference's) wrote: numpy arrays
    at the leaves, CPU torch tensors for bf16 ones, lists and tuples
    rebuilt from their markers."""
    with open(path, "rb") as f:
        flat = unpackb(f.read())

    root: dict[str, Any] = {}
    seqs: dict[str, str] = {}
    for key, val in flat.items():
        parts = [p for p in key.split("/") if p]
        if parts and parts[-1] == "__seq__":
            seqs["/".join(parts[:-1])] = val
            continue
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _array(val) if isinstance(val, dict) else val

    def to_seq(node, path=""):
        if not isinstance(node, dict):
            return node
        node = {k: to_seq(v, f"{path}/{k}") for k, v in node.items()}
        kind = seqs.get(path.lstrip("/"))
        if kind is not None:
            items = [node[k] for k in sorted(node)]
            return tuple(items) if kind == "tuple" else items
        return node

    return to_seq(root, "")
