"""Reference reports of the JAX package's operator dashboard.

Runs ``python -m aosx.dashboard`` in process (its ``main`` under a patched
``sys.argv``) on the CPU for every argument set of ``RUNS`` and writes
``dashboard_np.json`` beside this file: per run its arguments, the report
the dashboard printed and the run's seconds. ``chip_smoke.py`` (phase 10)
and ``tests/test_torch_dashboard.py`` hold ``aosx_torch.dashboard``'s
reports to these.

The maps are the verify recipe's: ``make_orchard_np(OrchardSpec(n_rows=3,
row_len=12.0, origin=(6.0, 4.0)), seed=1)`` saved as one PCD with its
polygon JSON, and its points shuffled by ``default_rng(0)`` and cut at
0.55, 0.8 and 1.0 of their count into three growing snapshots. ``{map}``,
``{poly}`` and ``{seq}`` in an argument list stand for those files.

Run from the repository root (about 10 minutes, mostly XLA:CPU compiles of
the episode scans):

    JAX_PLATFORMS=cpu python tests/torch_reference/make_dashboard_reference.py
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

OUT = pathlib.Path(__file__).resolve().with_name("dashboard_np.json")
SEQ_FRACTIONS = (0.55, 0.8, 1.0)
# name -> dashboard arguments (--device cpu and --out are added)
RUNS = {
    # phase 10 (b) of chip_smoke.py
    "orchard_seed1_300": ["--steps", "300", "--seed", "1"],
    "pcd_300": ["--steps", "300", "--pcd", "{map}", "--polygon", "{poly}"],
    "seq_cached_2400": ["--steps", "2400", "--pcd-seq", "{seq}", "--polygon", "{poly}",
                        "--cached"],
    "seq_serve_2400": ["--steps", "2400", "--pcd-seq", "{seq}", "--polygon", "{poly}",
                       "--serve"],
    # tests/test_torch_dashboard.py
    "pcd_60": ["--steps", "60", "--pcd", "{map}", "--polygon", "{poly}"],
    "seq_cached_90": ["--steps", "90", "--pcd-seq", "{seq}", "--polygon", "{poly}", "--cached"],
    "seq_serve_90": ["--steps", "90", "--pcd-seq", "{seq}", "--polygon", "{poly}", "--serve"],
}


def write_maps(d: pathlib.Path, make_orchard_np, OrchardSpec, save_pcd) -> dict:
    """The verify recipe's map, polygon and snapshots in ``d``; returns the
    placeholder values."""
    xyz, poly = make_orchard_np(OrchardSpec(n_rows=3, row_len=12.0, origin=(6.0, 4.0)), seed=1)
    save_pcd(str(d / "map.pcd"), xyz.astype(np.float32))
    (d / "poly.json").write_text(json.dumps([list(map(float, p)) for p in poly]))
    xyz = xyz[np.random.default_rng(0).permutation(len(xyz))]
    seq = []
    for f, frac in enumerate(SEQ_FRACTIONS):
        seq.append(str(d / f"seq_{f}.pcd"))
        save_pcd(seq[-1], xyz[:int(len(xyz) * frac)].astype(np.float32))
    return {"map": str(d / "map.pcd"), "poly": str(d / "poly.json"), "seq": ",".join(seq)}


def expand(args, paths: dict):
    return [a.format(**paths) for a in args]


def main():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import jax

    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    from aosx import dashboard
    from aosx.io.pcd import save_pcd
    from aosx.orchards import OrchardSpec, make_orchard_np

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        paths = write_maps(tmp, make_orchard_np, OrchardSpec, save_pcd)
        for name, args in RUNS.items():
            argv = ["aosx.dashboard", *expand(args, paths), "--device", "cpu",
                    "--out", str(tmp / name)]
            buf = io.StringIO()
            t0 = time.time()
            old = sys.argv
            sys.argv = argv
            try:
                with contextlib.redirect_stdout(buf):
                    dashboard.main()
            finally:
                sys.argv = old
            seconds = time.time() - t0
            text = buf.getvalue()
            report = json.JSONDecoder().raw_decode(text[text.index("{"):])[0]
            runs[name] = dict(args=args, report=report, seconds=round(seconds, 1))
            print(name, f"{seconds:.1f} s", json.dumps(report), flush=True)
    OUT.write_text(json.dumps(dict(seq_fractions=list(SEQ_FRACTIONS), runs=runs), indent=1)
                   + "\n")
    print("wrote", OUT)


if __name__ == "__main__":
    main()
