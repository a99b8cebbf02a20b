"""benchmarks/sweep_trace.py's HLO reading on the CPU: the loop body of a
chunk, the bytes of each kernel's operands and result, and the table that
puts them beside a traced time."""

import jax.numpy as jnp
import pytest

from benchmarks import sweep_trace
from wavefarm.models import potentials as pmod
from wavefarm.ops import stencil

N = 16


def _chunk_hlo(n_lower: int, dtype) -> str:
    cfg = sweep_trace._config(N, "Harmonic")
    v = pmod.generate(cfg).astype(dtype)
    a, b = pmod.build_ab(v, cfg.grid.dt)
    phi = jnp.ones(cfg.padded_size(), dtype)
    store = jnp.stack([phi] * n_lower) if n_lower else None
    return stencil.evolve_chunk.lower(
        phi, a, b, store, "ThreePoint", cfg.grid.dt, cfg.grid.dn, 1.0, 10,
        n_lower,
    ).compile().as_text()


@pytest.mark.parametrize("n_lower", [0, 2])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.complex64],
                         ids=["f32", "c64"])
def test_hlo_kernels_of_chunk(n_lower, dtype):
    """Every kernel of the loop body moves bytes; the ones together read
    at least ψ, A and B once and write ψ once, and no kernel counts more
    than its operands and result."""
    text = _chunk_hlo(n_lower, dtype)
    kernels = sweep_trace.hlo_kernels(text)
    assert kernels
    item = jnp.dtype(dtype).itemsize
    padded, interior = item * (N + 2) ** 3, item * N ** 3
    assert sum(k["operand_bytes"] for k in kernels.values()) >= 3 * interior
    assert max(k["result_bytes"] for k in kernels.values()) >= interior
    assert all(k["result_bytes"] <= padded * (1 + n_lower)
               for k in kernels.values())
    facts = sweep_trace.hlo_facts(text)
    assert facts["kernels_in_loop_body"] == len(kernels)
    assert "while(" not in sweep_trace.loop_body(text)


_MODULE = """
%fused_update (param_0.1: f32[6,6], param_1.2: f32[4,4]) -> f32[6,6] {
  %param_0.1 = f32[6,6]{1,0} parameter(0)
  %param_1.2 = f32[4,4]{1,0} parameter(1)
  %constant_1 = s32[] constant(1)
  ROOT %dynamic-update-slice.1 = f32[6,6]{1,0} dynamic-update-slice(%param_0.1, %param_1.2, %constant_1, %constant_1)
}

%fused_sliced (param_0.2: f32[2,6,6], param_1.3: f32[6,6]) -> f32[4,4] {
  %param_0.2 = f32[2,6,6]{2,1,0} parameter(0)
  %slice.1 = f32[1,6,6]{2,1,0} slice(%param_0.2), slice={[0:1], [0:6], [0:6]}
  %param_1.3 = f32[6,6]{1,0} parameter(1)
  %slice.2 = f32[4,4]{1,0} slice(%param_1.3), slice={[1:5], [1:5]}
  %slice.3 = f32[4,4]{1,0} slice(%param_1.3), slice={[2:6], [1:5]}
  ROOT %add.1 = f32[4,4]{1,0} add(%slice.2, %slice.3)
}

%body (arg: (s32[], f32[6,6], f32[2,6,6])) -> (s32[], f32[6,6], f32[2,6,6]) {
  %arg = (s32[], f32[6,6]{1,0}, f32[2,6,6]{2,1,0}) parameter(0)
  %x = f32[6,6]{1,0} get-tuple-element(%arg), index=1
  %s = f32[2,6,6]{2,1,0} get-tuple-element(%arg), index=2
  %f.1 = f32[4,4]{1,0} fusion(%s, %x), kind=kLoop, calls=%fused_sliced
  %f.2 = f32[6,6]{1,0} fusion(%x, %f.1), kind=kLoop, calls=%fused_update
  ROOT %t = (s32[], f32[6,6]{1,0}, f32[2,6,6]{2,1,0}) tuple(%i, %f.2, %s)
}

ENTRY %main (p: (s32[], f32[6,6], f32[2,6,6])) -> f32[6,6] {
  %p = (s32[], f32[6,6]{1,0}, f32[2,6,6]{2,1,0}) parameter(0)
  %w = (s32[], f32[6,6]{1,0}, f32[2,6,6]{2,1,0}) while(%p), condition=%cond, body=%body
}
"""


def test_hlo_kernels_must_move():
    """Slices read what they reach (one state of two; the rows two shifted
    slices cover, capped at the operand); an in-place update reads its
    base outside the update only and writes the update only."""
    assert sweep_trace.hlo_kernels(_MODULE) == {
        "f_1": {"opcode": "fusion", "result_bytes": 64,
                "operand_bytes": 144 + 128},
        "f_2": {"opcode": "fusion", "result_bytes": 64,
                "operand_bytes": (144 - 64) + 64},
    }
    assert sweep_trace.hlo_facts(_MODULE) == {
        "kernels_in_loop_body": 2, "copies_in_loop_body": 0,
        "in_place_update_kernels": 1,
    }


def test_kernel_table_bandwidth():
    trace = {"f_1": {"ns_per_call": 1000.0, "per_call": 1.0},
             "MemcpyD2D": {"ns_per_call": 10.0, "per_call": 0.5}}
    hlo = {"f_1": {"opcode": "fusion", "result_bytes": 4000,
                   "operand_bytes": 8000}}
    rows = sweep_trace.kernel_table(trace, hlo, updates=1000, peak=24e9)
    assert [r["name"] for r in rows] == ["f_1", "MemcpyD2D"]
    assert rows[0]["read_bytes_per_update"] == 8.0
    assert rows[0]["written_bytes_per_update"] == 4.0
    assert rows[0]["must_move_bytes_per_s"] == pytest.approx(12e9)
    assert rows[0]["share_of_peak"] == pytest.approx(0.5)
    assert "opcode" not in rows[1]


@pytest.mark.parametrize("name,expected", [
    ("%wrapped_slice.1", "wrapped_slice_1"),
    ("loop_dynamic_update_slice_fusion", "loop_dynamic_update_slice_fusion"),
    ("get-tuple-element.3", "get_tuple_element_3"),
])
def test_kernel_name(name, expected):
    assert sweep_trace.kernel_name(name) == expected
