"""Configuration schema, validation and pretty-printing.

Mirrors the reference's YAML schema and semantics (src/config.rs:14-64,
292-370) so existing ``wafer.yaml`` files work unchanged, while adding a few
optional extensions (``precision``, ``mesh``, ``cornell``) that default to
reference behaviour when absent.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from wavefarm import errors


class PotentialType(enum.Enum):
    """Built-in potential families (reference: src/config.rs:73-104)."""

    NO_POTENTIAL = "NoPotential"
    CUBE = "Cube"
    QUAD_WELL = "QuadWell"
    PERIODIC = "Periodic"
    COULOMB = "Coulomb"
    COMPLEX_COULOMB = "ComplexCoulomb"
    ELIPTICAL_COULOMB = "ElipticalCoulomb"
    SIMPLE_CORNELL = "SimpleCornell"
    FULL_CORNELL = "FullCornell"
    HARMONIC = "Harmonic"
    COMPLEX_HARMONIC = "ComplexHarmonic"
    # Extension beyond the reference enum (src/config.rs:73-104): the
    # absorptive finite-T quarkonium potential — (1 + i·absorb) times the
    # Debye-screened anisotropic FullCornell. The reference's Complex*
    # entries are real stubs (src/potential.rs:222,271); this adds the
    # complex potential its finite-T physics actually calls for.
    COMPLEX_FULL_CORNELL = "ComplexFullCornell"
    DODECAHEDRON = "Dodecahedron"
    FROM_FILE = "FromFile"
    FROM_SCRIPT = "FromScript"

    @property
    def variable_pot_sub(self) -> bool:
        """True when potential_sub is a full array rather than a scalar
        (reference: src/config.rs:106-126). Only the FullCornell family
        qualifies; the complex variant shares the real part's V(∞) array
        (the absorptive factor scales V, not the binding offset read from
        the real part)."""
        return self in (
            PotentialType.FULL_CORNELL, PotentialType.COMPLEX_FULL_CORNELL
        )

    @property
    def is_complex(self) -> bool:
        """Potentials that propagate a complex wavefunction.

        The reference stubs these out as real (src/potential.rs:222,271);
        here complex propagation is an actual capability."""
        return self in (
            PotentialType.COMPLEX_COULOMB,
            PotentialType.COMPLEX_HARMONIC,
            PotentialType.COMPLEX_FULL_CORNELL,
        )

    @property
    def real_counterpart(self) -> "PotentialType":
        """The real potential a Complex* type scales by (1 + i·absorb) —
        used for split-(re, im) generation and for real-valued side
        effects (initial conditions, pot_sub, saved potential)."""
        return {
            PotentialType.COMPLEX_COULOMB: PotentialType.COULOMB,
            PotentialType.COMPLEX_HARMONIC: PotentialType.HARMONIC,
            PotentialType.COMPLEX_FULL_CORNELL: PotentialType.FULL_CORNELL,
        }[self]

    def display(self) -> str:
        return {
            PotentialType.NO_POTENTIAL: "No potential (V=0)",
            PotentialType.CUBE: "3D square (i.e. cubic) well",
            PotentialType.QUAD_WELL: "3D quad well (short side along z-axis)",
            PotentialType.PERIODIC: "Periodic",
            PotentialType.COULOMB: "Coulomb",
            PotentialType.COMPLEX_COULOMB: "Complex coulomb",
            PotentialType.ELIPTICAL_COULOMB: "Eliptical coulomb",
            PotentialType.SIMPLE_CORNELL: "Cornell",
            PotentialType.FULL_CORNELL: "Fully anisotropic screened Cornell + spin correction",
            PotentialType.HARMONIC: "Harmonic oscillator",
            PotentialType.COMPLEX_HARMONIC: "Complex harmonic oscillator",
            PotentialType.COMPLEX_FULL_CORNELL: (
                "Complex screened Cornell (finite-T absorptive)"
            ),
            PotentialType.DODECAHEDRON: "Dodecahedron",
            PotentialType.FROM_FILE: "User generated potential from file",
            PotentialType.FROM_SCRIPT: "User generated potential from script",
        }[self]


class InitialCondition(enum.Enum):
    """First guess for the wavefunction (reference: src/config.rs:151-170)."""

    FROM_FILE = "FromFile"
    GAUSSIAN = "Gaussian"
    COULOMB = "Coulomb"
    CONSTANT = "Constant"
    BOOLEAN = "Boolean"

    def display(self) -> str:
        return {
            InitialCondition.FROM_FILE: "From file on disk",
            InitialCondition.GAUSSIAN: "Random Gaussian",
            InitialCondition.COULOMB: "Coulomb-like",
            InitialCondition.CONSTANT: "Constant of 0.1 in interior",
            InitialCondition.BOOLEAN: "Boolean test grid",
        }[self]


class SymmetryConstraint(enum.Enum):
    """Optional parity constraint about a mid-plane (reference: src/config.rs:184-209)."""

    NOT_CONSTRAINED = "NotConstrained"
    ABOUT_Z = "AboutZ"
    ANTISYM_ABOUT_Z = "AntisymAboutZ"
    ABOUT_Y = "AboutY"
    ANTISYM_ABOUT_Y = "AntisymAboutY"

    @property
    def sign(self) -> float:
        if self is SymmetryConstraint.NOT_CONSTRAINED:
            return 0.0
        if self in (SymmetryConstraint.ANTISYM_ABOUT_Y, SymmetryConstraint.ANTISYM_ABOUT_Z):
            return -1.0
        return 1.0

    @property
    def axis(self) -> Optional[int]:
        """Array axis the mirror applies to (x=0, y=1, z=2), or None."""
        if self in (SymmetryConstraint.ABOUT_Z, SymmetryConstraint.ANTISYM_ABOUT_Z):
            return 2
        if self in (SymmetryConstraint.ABOUT_Y, SymmetryConstraint.ANTISYM_ABOUT_Y):
            return 1
        return None

    def display(self) -> str:
        return {
            SymmetryConstraint.NOT_CONSTRAINED: "None",
            SymmetryConstraint.ABOUT_Z: "Symmetric about z-axis",
            SymmetryConstraint.ANTISYM_ABOUT_Z: "Antisymmetric about z-axis",
            SymmetryConstraint.ABOUT_Y: "Symmetric about y-axis",
            SymmetryConstraint.ANTISYM_ABOUT_Y: "Antisymmetric about y-axis",
        }[self]


class CentralDifference(enum.Enum):
    """Central-difference order (reference: src/config.rs:211-249).

    ``bb`` is the full per-axis padding of the allocated arrays and ``ext``
    the one-sided halo width: array size = N + bb with bb = 2·ext.
    """

    THREE_POINT = "ThreePoint"
    FIVE_POINT = "FivePoint"
    SEVEN_POINT = "SevenPoint"

    @property
    def bb(self) -> int:
        return {"ThreePoint": 2, "FivePoint": 4, "SevenPoint": 6}[self.value]

    @property
    def ext(self) -> int:
        return {"ThreePoint": 1, "FivePoint": 2, "SevenPoint": 3}[self.value]

    def display(self) -> str:
        return {
            CentralDifference.THREE_POINT: "Three point: O(Δ{x,y,z}²)",
            CentralDifference.FIVE_POINT: "Five point: O(Δ{x,y,z}⁴)",
            CentralDifference.SEVEN_POINT: "Seven point: O(Δ{x,y,z}⁶)",
        }[self]


class FileType(enum.Enum):
    """Output/input serialisation formats (reference: src/config.rs:251-289)."""

    MESSAGEPACK = "Messagepack"
    CSV = "Csv"
    JSON = "Json"
    YAML = "Yaml"
    RON = "Ron"

    @property
    def extension(self) -> str:
        return {
            FileType.MESSAGEPACK: ".mpk",
            FileType.CSV: ".csv",
            FileType.JSON: ".json",
            FileType.YAML: ".yaml",
            FileType.RON: ".ron",
        }[self]

    def display(self) -> str:
        return {
            FileType.MESSAGEPACK: "Messagepack",
            FileType.CSV: "CSV",
            FileType.JSON: "JSON",
            FileType.YAML: "YAML",
            FileType.RON: "RON",
        }[self]


@dataclass
class Index3:
    x: int
    y: int
    z: int

    def as_tuple(self):
        return (self.x, self.y, self.z)


@dataclass
class Grid:
    """Grid geometry: point counts and step sizes (reference: src/config.rs:14-23)."""

    size: Index3
    dn: float
    dt: float


@dataclass
class OutputConfig:
    """Output cadence and formats (reference: src/config.rs:48-64)."""

    screen_update: int
    file_type: FileType
    save_wavefns: bool
    save_potential: bool
    snap_update: Optional[int] = None


@dataclass
class CornellParams:
    """FullCornell physics inputs the reference hardcodes with TODOs
    (src/potential.rs:252-253,331-332,375,395-396). Optional ``cornell:``
    block in the YAML overrides them."""

    t: float = 1.0
    xi: float = 0.0
    nf: float = 2.0
    tc: float = 0.2


@dataclass
class MeshConfig:
    """Extension: device-mesh shape for sharded runs. ``slices·x*y*z``
    must equal the participating device count. Defaults to single-device.

    ``slices > 1`` enables the multi-slice tier: the grid's x axis is
    sharded over ``slices × x`` devices in a hierarchical ``(sl, gx, gy,
    gz)`` mesh whose slice axis lands on process boundaries under
    ``jax.distributed``; the slice-crossing x exchange runs at the slower
    ``slice_update`` cadence with correspondingly deeper halos
    (parallel/multislice.py)."""

    x: int = 1
    y: int = 1
    z: int = 1
    slices: int = 1
    slice_update: int = 4  # steps between slice-axis exchanges

    def as_tuple(self):
        return (self.x, self.y, self.z)

    @property
    def n_devices(self) -> int:
        return self.slices * self.x * self.y * self.z


@dataclass
class Config:
    """All run parameters (reference: src/config.rs:292-333)."""

    project_name: str
    grid: Grid
    tolerance: float
    central_difference: CentralDifference
    wavenum: int
    wavemax: int
    output: OutputConfig
    potential: PotentialType
    mass: float
    init_condition: InitialCondition
    sig: float
    init_symmetry: SymmetryConstraint
    max_steps: Optional[int] = None
    script_location: Optional[str] = None
    # --- extensions (optional in YAML) ---
    precision: str = "f64"  # "f32" | "f64" — dtype policy for the sweep
    # Absorptive strength for the Complex* potentials: V → (1 + i·absorb)·V.
    # Default 0 reproduces the reference's real-valued stubs
    # (src/potential.rs:222,271) while still propagating a complex ψ.
    absorb: float = 0.0
    # Sweep backend. Every run takes the XLA shifted-slice sweep; "auto"
    # and "xla" both name it and are accepted so existing configs load.
    backend: str = "auto"  # "auto" | "xla"
    # Runtime numeric sanitizer — the counterpart of the reference's
    # noisy_float NaN panics (SURVEY §5): flips on jax_debug_nans.
    debug_nans: bool = False
    # Optional jax.profiler trace directory (per-run performance traces).
    trace_dir: Optional[str] = None
    # Optional PRNG seed for the Gaussian initial condition (reproducible
    # runs; the reference uses a non-deterministic thread rng).
    seed: Optional[int] = None
    # Chunks per host↔device sync: the solver batches this many
    # screen_update chunks into one device-side scan with an on-device
    # convergence check, so the host pays one round trip per batch instead
    # of per chunk. Off by default: the batched scan is a separate compile.
    # None/1 = the reference's per-chunk cadence (src/grid.rs:126-220)
    # exactly.
    sync_update: Optional[int] = None
    # Delayed re-orthogonalisation (SURVEY §7's excited-state lever):
    # when True (default), excited-state chunks drop the per-step
    # Gram-Schmidt projections (reference cadence: src/grid.rs:674-681)
    # and project only at measure boundaries, WHENEVER the regrowth
    # numerics gate holds the projected energy bias far below the
    # convergence tolerance (solver.delayed_gram_gate — tolerance-
    # equivalent results, docs/PARITY.md divergence 12). False restores
    # the reference's exact per-step projection unconditionally.
    delayed_gram: bool = True
    # Multigrid (coarse→fine) schedule: a strictly-decreasing list of
    # integer divisors, e.g. [4, 2] solves size/4 → size/2 → full size,
    # upsampling each level's converged states (trilinear, the same
    # resampler as resolution-changing restarts) as the next level's
    # initial conditions. The physical box is preserved (dn_ℓ = dn·d) and
    # dt_ℓ = dt·d² keeps the stability margin exactly, so a coarse level
    # covers imaginary time d²× faster per step — this automates the
    # reference's documented manual coarse→fine restart speedup
    # (src/config.rs:156-160) in memory, without file round trips.
    multigrid: Optional[List[int]] = None
    # Convergence tolerance for the coarse (non-final) levels; defaults to
    # ``tolerance``. Looser values hand over sooner — the final level
    # always converges to ``tolerance``.
    multigrid_tolerance: Optional[float] = None
    cornell: CornellParams = field(default_factory=CornellParams)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    input_dir: str = "./input"
    output_root: str = "./output"

    # ------------------------------------------------------------------ #

    @property
    def dtype(self):
        import jax.numpy as jnp

        real = jnp.float64 if self.precision == "f64" else jnp.float32
        if self.potential.is_complex:
            return jnp.complex128 if self.precision == "f64" else jnp.complex64
        return real

    @property
    def real_dtype(self):
        import jax.numpy as jnp

        return jnp.float64 if self.precision == "f64" else jnp.float32

    def padded_size(self):
        bb = self.central_difference.bb
        s = self.grid.size
        return (s.x + bb, s.y + bb, s.z + bb)

    def work_size(self):
        s = self.grid.size
        return (s.x, s.y, s.z)

    # ------------------------------------------------------------------ #

    @classmethod
    def from_dict(cls, raw: Dict[str, Any], script: Optional[str] = None) -> "Config":
        """Build a validated Config from parsed YAML. Unknown keys are
        ignored (serde-compatible leniency)."""
        try:
            size = raw["grid"]["size"]
            grid = Grid(
                size=Index3(int(size["x"]), int(size["y"]), int(size["z"])),
                dn=float(raw["grid"]["dn"]),
                dt=float(raw["grid"]["dt"]),
            )
            out = raw["output"]
            output = OutputConfig(
                screen_update=int(out["screen_update"]),
                snap_update=(int(out["snap_update"]) if out.get("snap_update") is not None else None),
                file_type=FileType(out["file_type"]),
                save_wavefns=bool(out["save_wavefns"]),
                save_potential=bool(out["save_potential"]),
            )
            cornell_raw = raw.get("cornell", {}) or {}
            mesh_raw = raw.get("mesh", {}) or {}
            cfg = cls(
                project_name=str(raw["project_name"]),
                grid=grid,
                tolerance=float(raw["tolerance"]),
                central_difference=CentralDifference(raw["central_difference"]),
                max_steps=(int(raw["max_steps"]) if raw.get("max_steps") is not None else None),
                wavenum=int(raw["wavenum"]),
                wavemax=int(raw["wavemax"]),
                output=output,
                potential=PotentialType(raw["potential"]),
                mass=float(raw["mass"]),
                init_condition=InitialCondition(raw["init_condition"]),
                sig=float(raw["sig"]),
                init_symmetry=SymmetryConstraint(raw["init_symmetry"]),
                precision=str(raw.get("precision", "f64")),
                absorb=float(raw.get("absorb", 0.0)),
                backend=str(raw.get("backend", "auto")),
                seed=(int(raw["seed"]) if raw.get("seed") is not None else None),
                delayed_gram=bool(raw.get("delayed_gram", True)),
                sync_update=(
                    int(raw["sync_update"])
                    if raw.get("sync_update") is not None
                    else None
                ),
                multigrid=(
                    [int(d) for d in raw["multigrid"]]
                    if raw.get("multigrid") is not None
                    else None
                ),
                multigrid_tolerance=(
                    float(raw["multigrid_tolerance"])
                    if raw.get("multigrid_tolerance") is not None
                    else None
                ),
                debug_nans=bool(raw.get("debug_nans", False)),
                trace_dir=raw.get("trace_dir"),
                cornell=CornellParams(
                    t=float(cornell_raw.get("t", 1.0)),
                    xi=float(cornell_raw.get("xi", 0.0)),
                    nf=float(cornell_raw.get("nf", 2.0)),
                    tc=float(cornell_raw.get("tc", 0.2)),
                ),
                mesh=MeshConfig(
                    x=int(mesh_raw.get("x", 1)),
                    y=int(mesh_raw.get("y", 1)),
                    z=int(mesh_raw.get("z", 1)),
                    slices=int(mesh_raw.get("slices", 1)),
                    slice_update=int(mesh_raw.get("slice_update", 4)),
                ),
            )
        except errors.WaferError:
            raise
        except (KeyError, ValueError, TypeError) as exc:
            raise errors.ConfigParseError(f"invalid configuration: {exc}") from exc

        cfg.validate()

        if cfg.potential is PotentialType.FROM_SCRIPT:
            cfg.script_location = "./" + (script if script is not None else "gen_potential.py")
        else:
            cfg.script_location = None
        return cfg

    @classmethod
    def load(cls, file: str, script: Optional[str] = None, setup_output: bool = True) -> "Config":
        """Read + parse YAML; optionally create the run directory and copy
        the config into it (reference: src/config.rs:337-358)."""
        from wavefarm.io import yaml_subset

        try:
            with open(file, "r") as fh:
                raw = yaml_subset.loads(fh.read())
        except OSError as exc:
            raise errors.ConfigLoadError(file) from exc
        except yaml_subset.YamlError as exc:
            raise errors.DeserializeError() from exc
        if not isinstance(raw, dict):
            raise errors.DeserializeError()

        cfg = cls.from_dict(raw, script=script)

        if setup_output:
            from wavefarm.io import run_dir

            run_dir.check_output_dir(cfg.project_name, cfg.output_root)
            run_dir.copy_config(cfg.project_name, file, cfg.output_root)
        return cfg

    def validate(self) -> None:
        """Semantic checks the schema can't express
        (reference: src/config.rs:362-370)."""
        if self.grid.dt > self.grid.dn ** 2 / 3.0:
            raise errors.LargeDtError()
        if self.wavenum > self.wavemax:
            raise errors.LargeWavenumError()
        if self.precision not in ("f32", "f64"):
            raise errors.ConfigParseError(f"precision must be f32 or f64, got {self.precision!r}")
        if self.backend == "pallas":
            raise errors.ConfigParseError(
                "backend: pallas is no longer available: its Pallas kernels "
                "were written for another accelerator and were removed; every "
                "run takes the XLA sweep (use backend: auto or xla, or omit "
                "the key)"
            )
        if self.backend not in ("auto", "xla"):
            raise errors.ConfigParseError(f"backend must be auto or xla, got {self.backend!r}")
        if min(self.mesh.as_tuple()) < 1 or self.mesh.slices < 1:
            raise errors.ConfigParseError("mesh axes must be >= 1")
        if self.mesh.slice_update < 1:
            raise errors.ConfigParseError("mesh.slice_update must be >= 1")
        if self.sync_update is not None and self.sync_update < 1:
            raise errors.ConfigParseError("sync_update must be >= 1")
        if self.multigrid is not None:
            if not self.multigrid:
                raise errors.ConfigParseError(
                    "multigrid must be a non-empty list of divisors"
                )
            s = self.grid.size
            floor = max(8, 2 * self.central_difference.ext + 2)
            prev = None
            for d in self.multigrid:
                if d < 2:
                    raise errors.ConfigParseError(
                        f"multigrid divisors must be >= 2, got {d}"
                    )
                if prev is not None and d >= prev:
                    raise errors.ConfigParseError(
                        "multigrid divisors must be strictly decreasing "
                        f"(coarse to fine), got {self.multigrid}"
                    )
                if s.x % d or s.y % d or s.z % d:
                    raise errors.ConfigParseError(
                        f"multigrid divisor {d} does not divide the grid "
                        f"size ({s.x}, {s.y}, {s.z})"
                    )
                if min(s.x, s.y, s.z) // d < floor:
                    raise errors.ConfigParseError(
                        f"multigrid divisor {d} makes the coarse grid "
                        f"smaller than {floor} points per axis"
                    )
                prev = d
            if self.wavenum > 0:
                raise errors.ConfigParseError(
                    "multigrid requires wavenum: 0 (lower states restart "
                    "from disk at the final resolution only)"
                )
            # multigrid + multi-device mesh is supported: coarse levels
            # solve on a single device (they are >= 8x smaller), only the
            # final full-resolution level runs sharded (solver._run_multigrid)
        if self.multigrid_tolerance is not None and (
            self.multigrid_tolerance < self.tolerance
        ):
            raise errors.ConfigParseError(
                "multigrid_tolerance must be >= tolerance"
            )

    # ------------------------------------------------------------------ #

    def pretty(self, w: int = 100) -> str:
        """Adaptive two-layout parameter table (reference: src/config.rs:378-568)."""
        lines = []
        title = f" {self.project_name} - Configuration "
        lines.append(title.center(w, "═"))
        mid = w - 10
        pad = " " * 5

        def row(*cells, width):
            return pad + "".join(c.ljust(width) for c in cells)

        grid_s = f"Grid {{ x: {self.grid.size.x}, y: {self.grid.size.y}, z: {self.grid.size.z} }}"
        dn_s = f"Δ{{x,y,z}}: {self.grid.dn:.3e}"
        dt_s = f"Δt: {self.grid.dt:.3e}"
        snap_s = (
            f"Snapshot update: {self.output.snap_update}"
            if self.output.snap_update is not None
            else "Snapshot update: Off"
        )
        max_s = (
            f"Maximum number of steps: {float(self.max_steps):.3e}"
            if self.max_steps is not None
            else "Maximum number of steps: ∞"
        )
        init_s = (
            f"Initial conditions: {self.init_condition.display()} ({self.sig} σ)"
            if self.init_condition is InitialCondition.GAUSSIAN
            else f"Initial conditions: {self.init_condition.display()}"
        )
        if w > 95:
            cw, dw = mid // 4, mid // 2
            lines.append(pad + grid_s.ljust(dw) + dn_s.ljust(cw) + dt_s.ljust(cw))
            lines.append(
                row(
                    f"Screen update: {self.output.screen_update}",
                    snap_s,
                    f"Save wavefns: {str(self.output.save_wavefns).lower()}",
                    f"Save potential: {str(self.output.save_potential).lower()}",
                    width=cw,
                )
            )
            lines.append(
                row(
                    f"CD precision: {self.central_difference.display()}",
                    f"Output file format: {self.output.file_type.display()}",
                    width=dw,
                )
            )
            lines.append(
                pad
                + f"Potential: {self.potential.display()}".ljust(cw * 3)
                + f"Mass: {self.mass} amu".ljust(cw)
            )
            lines.append(
                row(f"Energy covergence tolerance: {self.tolerance:.3e}", max_s, width=dw)
            )
            lines.append(
                row(
                    f"Starting wavefunction: {self.wavenum}",
                    f"Maximum wavefunction: {self.wavemax}",
                    width=dw,
                )
            )
            lines.append(
                row(init_s, f"Symmetry Constraints: {self.init_symmetry.display()}", width=dw)
            )
        else:
            cw = mid // 2
            lines.append(pad + grid_s)
            lines.append(row(dn_s, dt_s, width=cw))
            lines.append(row(f"Screen update: {self.output.screen_update}", snap_s, width=cw))
            lines.append(
                row(
                    f"Save wavefns: {str(self.output.save_wavefns).lower()}",
                    f"Save potential: {str(self.output.save_potential).lower()}",
                    width=cw,
                )
            )
            lines.append(
                row(
                    f"CD precision: {self.central_difference.display()}",
                    f"Output file format: {self.output.file_type.display()}",
                    width=cw,
                )
            )
            lines.append(
                pad
                + f"Potential: {self.potential.display()}".ljust((mid // 4) * 3)
                + f"Mass: {self.mass} amu".ljust(mid // 4)
            )
            lines.append(
                row(f"Energy covergence tolerance: {self.tolerance:.3e}", max_s, width=cw)
            )
            lines.append(
                row(
                    f"Starting wavefunction: {self.wavenum}",
                    f"Maximum wavefunction: {self.wavemax}",
                    width=cw,
                )
            )
            lines.append(pad + init_s)
            lines.append(pad + f"Symmetry Constraints: {self.init_symmetry.display()}")
        lines.append("═" * w)
        return "\n".join(lines)

    def print(self, w: int = 100) -> None:
        print(self.pretty(w))
