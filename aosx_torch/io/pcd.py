"""PCD point-cloud IO for map replay (mirror of ``aosx/io/pcd.py``).

ASCII and binary PCD v0.7 with x/y/z fields (other fields are skipped).
Binary files go through the native reader (``aosx_torch/native``) wherever
a g++ can build it, else through numpy; both give the same f32 values."""

from __future__ import annotations

import numpy as np

from ..native import binding

_TYPES = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4",
          ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4"}


def load_pcd(path: str) -> np.ndarray:
    """[N, 3] f32 xyz."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header.get("FIELDS", "x y z").split()
        sizes = list(map(int, header.get("SIZE", "4 4 4").split()))
        types = header.get("TYPE", "F F F").split()
        counts = list(map(int, header.get("COUNT", " ".join("1" * len(fields))).split()))
        n = int(header.get("POINTS", header.get("WIDTH", "0")))
        kind = header["DATA"]
        if kind == "ascii":
            body = np.loadtxt(f, dtype=np.float64, max_rows=n)
            if body.ndim == 1:
                body = body[None, :]
            cols, ci = {}, 0
            for fld, cnt in zip(fields, counts):
                cols[fld] = ci
                ci += cnt
            return np.stack([body[:, cols["x"]], body[:, cols["y"]], body[:, cols["z"]]],
                            axis=1).astype(np.float32)
        if kind != "binary":
            raise ValueError(f"unsupported PCD DATA kind: {kind}")
        if binding.available():
            return binding.load_pcd_xyz(path)
        return _read_binary_numpy(f, fields, types, sizes, counts, n)


def _read_binary_numpy(f, fields, types, sizes, counts, n) -> np.ndarray:
    """The binary body after the header, read with numpy: the reader where the
    native one cannot be built."""
    dt = [(fld, _TYPES[(t, sz)], (cnt,)) if cnt > 1 else (fld, _TYPES[(t, sz)])
          for fld, t, sz, cnt in zip(fields, types, sizes, counts)]
    arr = np.frombuffer(f.read(), dtype=np.dtype(dt), count=n)
    return np.stack([arr["x"].astype(np.float32), arr["y"].astype(np.float32),
                     arr["z"].astype(np.float32)], axis=1)


def save_pcd(path: str, xyz: np.ndarray, binary: bool = True):
    """Write [N, 3] xyz as f32 PCD v0.7."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(xyz).tobytes())
        else:
            np.savetxt(f, xyz, fmt="%.6f")
