"""Device trace of the XLA sweep on one GPU: time, kernels and bytes per
step against the HBM roofline.

    python benchmarks/sweep_trace.py [--out scratch_runs/sweep_trace.json]
                                     [--hlo-dir scratch_runs/sweep_hlo]

For ground-state and S=2 excited chunks (per-step normalise + Gram-Schmidt,
ops/stencil.evolve_chunk) at 512³ and 256³ f32 ThreePoint, and a complex64
ground chunk at 256³, it records:

- host-clock time per step of warm chunks (``block_until_ready``);
- from a ``jax.profiler`` trace of one chunk: device kernel time per step,
  kernels launched per step, the device busy share of the window, and each
  kernel's time;
- for each kernel of the loop body, the bytes it must move per grid-point
  update, read from the optimised HLO (each element of its operands it
  touches read once, each element of its result it writes written once),
  and the bandwidth that takes in the kernel's traced time; their sum per
  step is the step's bytes per update (a lower bound on its DRAM traffic);
- the share of the published HBM bandwidth the sweep reaches at its
  compulsory traffic (read ψ, A, B; write ψ: 16 B/update in f32, 32 B in
  complex64), and the device time of a plain fused pass that moves exactly
  those bytes (``ψ·A + B`` over the interior) in the same run;
- XLA's static ``cost_analysis`` estimate of the bytes one step accesses,
  with the roofline share it would imply. It counts every shifted-slice
  read, most of which the L2 serves, so it is not DRAM traffic: a share
  above 1 says so;
- the kernels of the loop body, its unfused copies, and how many kernels
  update the padded ψ in place (``set_work_area``'s dynamic-update-slice).

64-bit types are enabled, as in the CLI, so Gram-Schmidt overlaps take the
solver's f32-row / f64-combine reduction. Exits non-zero without a GPU.
Traces go under ``scratch_runs/`` (not kept); the summary JSON is printed
and written to ``--out``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import sys
import time
from typing import NamedTuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from wavefarm import geometry  # noqa: E402
from wavefarm.config import Config  # noqa: E402
from wavefarm.models import potentials as pmod  # noqa: E402
from wavefarm.ops import gram_schmidt, stencil  # noqa: E402
from wavefarm.utils.runtime import (  # noqa: E402
    REPO_ROOT,
    card_identity,
    require_gpu,
    setup_compile_cache,
)

STEPS = 100
TRACE_DIR = os.path.join(REPO_ROOT, "scratch_runs", "traces")
_ITEMSIZE = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
             "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
             "f64": 8, "c64": 8, "c128": 16}
_SHAPE = re.compile(r"\b(" + "|".join(_ITEMSIZE) + r")\[([\d,]*)\]")
_NOT_KERNELS = {"parameter", "constant", "get-tuple-element", "tuple",
                "bitcast", "while", "conditional"}


def _config(n: int, potential: str) -> Config:
    return Config.from_dict({
        "project_name": "trace",
        "grid": {"size": {"x": n, "y": n, "z": n}, "dn": 0.05, "dt": 8e-4},
        "tolerance": 1e-6, "central_difference": "ThreePoint",
        "wavenum": 0, "wavemax": 0,
        "output": {"screen_update": STEPS, "file_type": "Json",
                   "save_wavefns": False, "save_potential": False},
        "potential": potential, "absorb": 0.2, "mass": 1.0,
        "init_condition": "Constant",
        "sig": 1.0, "init_symmetry": "NotConstrained", "precision": "f32",
    })


def kernel_name(hlo_name: str) -> str:
    """The name the profiler gives the kernel of an HLO instruction."""
    return re.sub(r"[.\-]", "_", hlo_name.lstrip("%"))


def trace_summary(trace_dir: str, n_calls: int) -> dict:
    """Reduce a profiler trace to per-call device numbers: kernel events on
    the GPU plane's stream lines (the lines other than the XLA Ops /
    Modules summaries), their summed durations, the busy union over the
    window, and each kernel's time."""
    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                  "*.xplane.pb"))[0]
    data = ProfileData.from_file(path)
    planes = [p for p in data.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise RuntimeError("trace has no GPU device plane")
    kernels = []
    for line in planes[0].lines:
        if line.name in ("XLA Ops", "XLA Modules", "Source code",
                         "Framework Ops", "Framework Name Scope"):
            continue
        for ev in line.events:
            kernels.append((ev.name, ev.start_ns, ev.duration_ns))
    if not kernels:
        raise RuntimeError("no kernel events on the GPU plane")
    start = min(k[1] for k in kernels)
    end = max(k[1] + k[2] for k in kernels)
    busy = 0.0
    cur_s = cur_e = None
    for _n, s, d in sorted(kernels, key=lambda k: k[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    busy += cur_e - cur_s
    by_name: dict = {}
    for name, _s, d in kernels:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + d, c + 1)
    return {
        "device_kernel_ns_per_call": sum(k[2] for k in kernels) / n_calls,
        "kernels_per_call": len(kernels) / n_calls,
        "busy_share": busy / (end - start),
        "window_ms": (end - start) / 1e6,
        "kernels": {n: {"ns_per_call": t / n_calls, "per_call": c / n_calls}
                    for n, (t, c) in by_name.items()},
    }


def device_ns(fn, args, n_calls: int, tag: str) -> float:
    """Summed device kernel time of one warm call of ``fn(*args)``."""
    out = fn(*args)
    jax.block_until_ready(out)
    tdir = os.path.join(TRACE_DIR, tag)
    shutil.rmtree(tdir, ignore_errors=True)
    with jax.profiler.trace(tdir):
        for _ in range(n_calls):
            out = fn(*args)
        jax.block_until_ready(out)
    return trace_summary(tdir, n_calls)["device_kernel_ns_per_call"]


def _shape_bytes(text: str) -> int:
    total = 0
    for ty, dims in _SHAPE.findall(text):
        total += _ITEMSIZE[ty] * int(np.prod([int(d) for d in dims.split(",")
                                              if d] or [1]))
    return total


def _operands(rest: str) -> str:
    """The operand list of an instruction: ``rest`` up to the parenthesis
    that closes the opcode's."""
    depth = 1
    for i, ch in enumerate(rest):
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0:
            return rest[:i]
    return rest


class _Instr(NamedTuple):
    root: bool
    name: str
    nbytes: int
    opcode: str
    operands: list
    rest: str


def _instructions(text: str) -> list:
    out = []
    for line in text.splitlines():
        m = re.match(r"\s*(ROOT\s+)?%?([\w.\-]+)\s*=\s*(\([^)]*\)|\S+)\s+"
                     r"([\w\-]+)\((.*)$", line)
        if m:
            root, name, shape, opcode, rest = m.groups()
            out.append(_Instr(bool(root), name, _shape_bytes(shape), opcode,
                              re.findall(r"%([\w.\-]+)", _operands(rest)),
                              rest))
    return out


def _computation(hlo_text: str, name: str) -> str:
    m = re.search(r"\n%?" + re.escape(name) + r" [^\n]*\{\n(.*?)\n\}",
                  hlo_text, flags=re.S)
    return m.group(1) if m else ""


def loop_body(hlo_text: str) -> str:
    """The largest while-loop body of an optimised HLO module (the per-step
    work of a chunk)."""
    names = re.findall(r"while\(.*?body=%?([\w.\-]+)", hlo_text)
    bodies = [b for b in (_computation(hlo_text, n) for n in names) if b]
    return max(bodies, key=len) if bodies else hlo_text


def fused_traffic(comp: str):
    """(bytes read of each parameter by index, bytes written) of a fused
    computation. A parameter used only through slices is read as far as
    those slices reach; one used only as the base of a dynamic-update-slice
    (updated in place) is read only outside the update; any other is read
    whole. A dynamic-update-slice root writes only its update."""
    ins = _instructions(comp)
    size = {i.name: i.nbytes for i in ins}
    reads, written = {}, None
    for i in ins:
        if i.opcode == "parameter":
            uses = [u for u in ins if i.name in u.operands]
            if uses and all(u.opcode == "slice" for u in uses):
                got = min(i.nbytes, sum(u.nbytes for u in uses))
            elif uses and all(u.opcode == "dynamic-update-slice"
                              and u.operands[0] == i.name for u in uses):
                got = i.nbytes - size.get(uses[0].operands[1], 0)
            else:
                got = i.nbytes
            reads[int(re.match(r"\d+", i.rest).group())] = got
        if i.root:
            written = (size.get(i.operands[1], i.nbytes)
                       if i.opcode == "dynamic-update-slice" else i.nbytes)
    return reads, written


def hlo_kernels(hlo_text: str) -> dict:
    """Per instruction of the loop body that launches work: its opcode and
    the bytes it must move at least, each element it touches once: the
    bytes of its operands it reads (``fused_traffic``) and of its result it
    writes."""
    ins = _instructions(loop_body(hlo_text))
    size = {i.name: i.nbytes for i in ins}
    out = {}
    for i in ins:
        if i.opcode in _NOT_KERNELS:
            continue
        calls = re.search(r"calls=%?([\w.\-]+)", i.rest)
        reads, written = (fused_traffic(_computation(hlo_text, calls.group(1)))
                          if calls else ({}, None))
        per_operand: dict = {}
        for pos, op in enumerate(i.operands):
            got = reads.get(pos, size.get(op, 0))
            per_operand[op] = max(per_operand.get(op, 0), got)
        out[kernel_name(i.name)] = {
            "opcode": i.opcode,
            "result_bytes": i.nbytes if written is None else written,
            "operand_bytes": sum(per_operand.values()),
        }
    return out


def hlo_facts(hlo_text: str) -> dict:
    """Kernels, unfused copies and in-place updates (fusions whose root is
    a dynamic-update-slice) of the loop body."""
    ins = [i for i in _instructions(loop_body(hlo_text))
           if i.opcode not in _NOT_KERNELS]
    in_place = 0
    for i in ins:
        calls = re.search(r"calls=%?([\w.\-]+)", i.rest)
        root = [r for r in _instructions(_computation(hlo_text, calls.group(1)))
                if r.root] if calls else []
        in_place += any(r.opcode == "dynamic-update-slice" for r in root)
    return {
        "kernels_in_loop_body": len(ins),
        "copies_in_loop_body": sum(i.opcode == "copy" for i in ins),
        "in_place_update_kernels": in_place,
    }


def kernel_table(trace_kernels: dict, hlo: dict, updates: int,
                 peak: float) -> list:
    """Each traced kernel beside the bytes its HLO instruction must move
    (``hlo_kernels``), per update, and the bandwidth that takes in the
    traced time. DRAM traffic can only be higher (re-reads the L2 misses),
    so a share of ``peak`` near 1 says the kernel streams at the card's
    rate and a low one says it does not."""
    rows = []
    for name, t in sorted(trace_kernels.items(),
                          key=lambda kv: -kv[1]["ns_per_call"]):
        row = {"name": name, "ns_per_step": t["ns_per_call"],
               "per_step": t["per_call"]}
        h = hlo.get(name)
        if h is not None and t["ns_per_call"] > 0:
            moved = h["result_bytes"] + h["operand_bytes"]
            row.update(
                opcode=h["opcode"],
                read_bytes_per_update=h["operand_bytes"] / updates,
                written_bytes_per_update=h["result_bytes"] / updates,
                must_move_bytes_per_s=moved * t["per_call"]
                / (t["ns_per_call"] * 1e-9),
            )
            row["share_of_peak"] = row["must_move_bytes_per_s"] / peak
        rows.append(row)
    return rows


def case(n: int, n_lower: int, peak: float, hlo_dir: str,
         complex_psi: bool = False) -> dict:
    """One traced configuration: f32 (Harmonic) or complex64
    (ComplexHarmonic) ψ at n³ with ``n_lower`` stored states."""
    cfg = _config(n, "ComplexHarmonic" if complex_psi else "Harmonic")
    order = cfg.central_difference.value
    ext = cfg.central_difference.ext
    dt, dn, mass = cfg.grid.dt, cfg.grid.dn, cfg.mass
    v = pmod.generate(cfg).astype(cfg.dtype)
    a, b = pmod.build_ab(v, dt)
    del v
    rng = np.random.default_rng(n + n_lower)
    pad = cfg.padded_size()
    dtype = jnp.dtype(cfg.dtype)
    tag = f"{n}_{n_lower}_{dtype}"

    def field():
        f = rng.standard_normal(pad, dtype=np.float32).astype(cfg.dtype)
        f = geometry.zero_boundary(jnp.asarray(f), ext)
        return f / jnp.sqrt(jnp.sum(jnp.abs(f) ** 2)).astype(f.dtype)

    phi = field()
    store = jnp.stack([field() for _ in range(n_lower)]) if n_lower else None

    def chunk(p):
        return stencil.evolve_chunk(p, a, b, store, order, dt, dn, mass,
                                    STEPS, n_lower)

    def one_step(p, a_, b_, s_):
        # one step of ``chunk``, for XLA's static byte estimate
        p = stencil.evolve_step(p, a_, b_, order, dt, dn, mass)
        if n_lower:
            p = gram_schmidt.normalise_wavefunction(
                p, gram_schmidt.get_norm_squared(p))
            p = gram_schmidt.orthogonalise_wavefunction(p, s_, n_lower)
        return p

    t0 = time.perf_counter()
    phi = chunk(phi).block_until_ready()
    compile_s = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        phi = chunk(phi).block_until_ready()
        walls.append(time.perf_counter() - t0)
    step_s = float(np.median(walls)) / STEPS

    tdir = os.path.join(TRACE_DIR, tag)
    shutil.rmtree(tdir, ignore_errors=True)
    with jax.profiler.trace(tdir):
        phi = chunk(phi).block_until_ready()
    tr = trace_summary(tdir, STEPS)

    hlo_text = stencil.evolve_chunk.lower(
        phi, a, b, store, order, dt, dn, mass, STEPS, n_lower
    ).compile().as_text()
    if hlo_dir:
        os.makedirs(hlo_dir, exist_ok=True)
        with open(os.path.join(hlo_dir, f"{tag}.txt"), "w") as fh:
            fh.write(hlo_text)

    # a plain fused pass over the interior with the sweep's compulsory
    # traffic: read ψ, A, B; write ψ'
    w, a_w, b_w = (geometry.work_area(x, ext) for x in (phi, a, b))
    floor_ns = device_ns(jax.jit(lambda p, x, y: p * x + y), (w, a_w, b_w),
                         10, tag + "_floor")
    del w, a_w, b_w

    cost = jax.jit(one_step).lower(phi, a, b, store).compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    updates = n ** 3
    rate = updates / step_s
    device_s = tr["device_kernel_ns_per_call"] * 1e-9
    model_bytes = bench.bytes_per_update(dtype.itemsize)
    xla_bytes = cost.get("bytes accessed", float("nan")) / updates
    kernels = kernel_table(tr["kernels"], hlo_kernels(hlo_text), updates, peak)
    must_move = sum(
        (k["read_bytes_per_update"] + k["written_bytes_per_update"])
        * k["per_step"] for k in kernels if "opcode" in k
    )
    return {
        "grid": n, "dtype": str(dtype),
        "stored_states": n_lower, "steps_per_chunk": STEPS,
        "compile_s": compile_s,
        "host_ms_per_step": step_s * 1e3,
        "updates_per_s": rate,
        "device_ms_per_step": device_s * 1e3,
        "device_updates_per_s": updates / device_s,
        "kernels_per_step": tr["kernels_per_call"],
        "busy_share": tr["busy_share"],
        "compulsory_bytes_per_update": model_bytes,
        "roofline_share_compulsory": updates / device_s * model_bytes / peak,
        "floor_pass_ms": floor_ns / 1e6,
        "floor_pass_bytes_per_s": updates * model_bytes / (floor_ns * 1e-9),
        "step_over_floor_pass": device_s / (floor_ns * 1e-9),
        "must_move_bytes_per_update": must_move,
        "roofline_share_must_move": updates / device_s * must_move / peak,
        "xla_static_estimate_bytes_per_update": xla_bytes,
        "xla_static_estimate_implied_roofline_share":
            updates / device_s * xla_bytes / peak,
        "hlo": hlo_facts(hlo_text),
        "kernels": kernels,
    }


def copy_bandwidth(n: int) -> float:
    """Bytes/s of x → x + 1 over an n³ f32 array (one read, one write),
    from its device kernel time."""
    x = jnp.ones((n, n, n), jnp.float32)
    ns = device_ns(jax.jit(lambda y: y + 1.0), (x,), 10, f"copy_{n}")
    return 2 * 4 * n ** 3 / (ns * 1e-9)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(REPO_ROOT, "scratch_runs",
                                                      "sweep_trace.json"))
    parser.add_argument("--hlo-dir", default="",
                        help="write each chunk's optimised HLO here")
    args = parser.parse_args()
    setup_compile_cache()
    gpu = require_gpu()
    jax.config.update("jax_enable_x64", True)
    peak = bench.peak_hbm(gpu.device_kind)
    out = {
        "device": {"platform": gpu.platform, "kind": gpu.device_kind,
                   "count": len(jax.devices())},
        "card": card_identity(),
        "peak_hbm_bytes_per_s": peak,
        "copy_bytes_per_s_512": copy_bandwidth(512),
        "cases": [],
    }
    for n, n_lower, cplx in ((512, 0, False), (512, 2, False),
                             (256, 0, False), (256, 2, False),
                             (256, 0, True)):
        out["cases"].append(case(n, n_lower, peak, args.hlo_dir, cplx))
        print(json.dumps(out["cases"][-1]), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "cases"}))


if __name__ == "__main__":
    main()
