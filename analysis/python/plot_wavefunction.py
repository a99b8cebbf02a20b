#!/usr/bin/env python
"""Offline analysis: load a run's config + CSV outputs and render slices.

Counterpart of the reference's yt loader (analysis/python/yt_plain.py:1-89):
reads ``wafer.yaml`` for grid geometry, loads ``potential.csv`` and
``wavefunction_{n}.csv`` (sparse i,j,k,data records), and renders mid-plane
slices — with yt volume rendering when yt is installed, matplotlib otherwise.

Usage:
    python plot_wavefunction.py <run_dir> [state] [--volume]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import yaml


def load_csv_array(path: str) -> np.ndarray:
    """Sparse PlainRecord CSV (i,j,k,data) → dense 3D array."""
    raw = np.loadtxt(path, delimiter=",")
    if raw.ndim == 1:
        raw = raw[None, :]
    i, j, k = raw[:, 0].astype(int), raw[:, 1].astype(int), raw[:, 2].astype(int)
    dims = (i.max() + 1, j.max() + 1, k.max() + 1)
    out = np.zeros(dims)
    out[i, j, k] = raw[:, 3]
    return out


def _load_obj_array(obj) -> np.ndarray:
    data = np.asarray(obj["data"])
    if data.ndim == 2 and data.shape[1] == 2:  # complex as (re, im) pairs
        data = data[:, 0] + 1j * data[:, 1]
    return data.reshape(obj["dim"])


def load_array(run_dir: str, stem: str):
    """Load ``stem`` in whichever of the 5 formats the run used
    (csv/json/yaml via stdlib; mpk/ron through wavefarm.io when the
    package is importable). Returns None when no file exists."""
    import json

    for ext in ("csv", "json", "yaml", "mpk", "ron"):
        path = os.path.join(run_dir, f"{stem}.{ext}")
        if not os.path.exists(path):
            continue
        if ext == "csv":
            return load_csv_array(path)
        if ext == "json":
            with open(path) as fh:
                return _load_obj_array(json.load(fh))
        if ext == "yaml":
            with open(path) as fh:
                return _load_obj_array(yaml.safe_load(fh))
        try:  # mpk / ron need the package's codecs
            from wavefarm.io import formats
        except ImportError as exc:  # pragma: no cover
            raise SystemExit(
                f"{path}: reading .{ext} needs wavefarm on PYTHONPATH"
            ) from exc
        with open(path, "rb") as fh:
            blob = fh.read()
        if ext == "mpk":
            return formats.array_from_mpk(blob)
        return formats.array_from_ron(blob.decode())
    return None


def load_run(run_dir: str, state: int = 0):
    cfgs = [f for f in os.listdir(run_dir) if f.endswith((".yaml", ".yml"))]
    cfgs = [f for f in cfgs if "observables" not in f and "wavefunction" not in f
            and "potential" not in f]
    if not cfgs:
        raise SystemExit(f"no config YAML found in {run_dir}")
    with open(os.path.join(run_dir, cfgs[0])) as fh:
        config = yaml.safe_load(fh)
    dn = float(config["grid"]["dn"])

    wfn = load_array(run_dir, f"wavefunction_{state}")
    if wfn is None:
        wfn = load_array(run_dir, f"wavefunction_{state}_partial")
    if wfn is None:
        raise SystemExit(f"no wavefunction_{state} output found in {run_dir}")
    pot = load_array(run_dir, "potential")
    return config, dn, wfn, pot


def plot_matplotlib(wfn: np.ndarray, pot, dn: float, state: int, out: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3 if pot is not None else 2, figsize=(14, 4))
    mid = wfn.shape[2] // 2
    im0 = axes[0].pcolormesh(wfn[:, :, mid].T, shading="auto", cmap="RdBu_r")
    axes[0].set_title(f"ψ_{state} z-midplane")
    fig.colorbar(im0, ax=axes[0])
    im1 = axes[1].pcolormesh((wfn ** 2).sum(axis=2).T, shading="auto", cmap="viridis")
    axes[1].set_title(f"∫|ψ_{state}|² dz")
    fig.colorbar(im1, ax=axes[1])
    if pot is not None:
        im2 = axes[2].pcolormesh(pot[:, :, pot.shape[2] // 2].T, shading="auto")
        axes[2].set_title("V z-midplane")
        fig.colorbar(im2, ax=axes[2])
    fig.tight_layout()
    fig.savefig(out, dpi=140)
    print(f"wrote {out}")


def plot_yt(wfn: np.ndarray, dn: float, state: int, out: str):
    """Volume render via yt when available (reference transposes to match
    yt's axis order — analysis/python/yt_plain.py)."""
    import yt  # type: ignore

    data = {"density": np.transpose(wfn ** 2, (1, 2, 0))}
    bbox = np.array([[0, s * dn] for s in data["density"].shape])
    ds = yt.load_uniform_grid(data, data["density"].shape, bbox=bbox)
    sc = yt.create_scene(ds, field="density")
    sc.save(out)
    print(f"wrote {out}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("state", nargs="?", type=int, default=0)
    ap.add_argument("--volume", action="store_true", help="yt volume render")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args()

    config, dn, wfn, pot = load_run(args.run_dir, args.state)
    out = args.out or f"wavefunction_{args.state}.png"
    if args.volume:
        try:
            plot_yt(wfn, dn, args.state, out)
            return
        except ImportError:
            print("yt not installed; falling back to matplotlib slices", file=sys.stderr)
    plot_matplotlib(wfn, pot, dn, args.state, out)


if __name__ == "__main__":
    main()
