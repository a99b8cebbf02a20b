"""Application shell: ``wafer [-c FILE] [-s FILE] [-d ...]``
(reference: src/main.rs:94-240)."""

from __future__ import annotations

import argparse
import sys
import time

from wavefarm import __version__, errors
from wavefarm.config import Config
from wavefarm.io import run_dir
from wavefarm.utils import logging as wlog
from wavefarm.utils import terminal


def _format_elapsed(time_taken: float) -> str:
    """Elapsed-time summary (reference: src/main.rs:215-238)."""
    if time_taken < 60.0:
        return f"Simulation complete. Elapsed time: {time_taken:.3f} seconds."
    if time_taken < 3600.0:
        minutes = int(time_taken // 60)
        seconds = time_taken - 60.0 * minutes
        return f"Simulation complete. Elapsed time: {minutes} minutes, {seconds:.3f} seconds."
    hours = int(time_taken // 3600)
    minutes = int((time_taken - 3600.0 * hours) // 60)
    seconds = time_taken - 3600.0 * hours - 60.0 * minutes
    return (
        f"Simulation complete. Elapsed time: {hours} hours, {minutes} minutes, "
        f"{seconds:.3f} seconds."
    )


def main(argv=None) -> int:
    start_time = time.time()
    parser = argparse.ArgumentParser(
        prog="wafer",
        description=(
            "Exploits a Wick-rotated time-dependent Schrödinger equation to solve "
            "for time-independent solutions in three dimensions."
        ),
    )
    parser.add_argument("-c", "--config", metavar="FILE", default="wafer.yaml",
                        help='The configuration file to use (default is "wafer.yaml")')
    parser.add_argument("-s", "--script", metavar="FILE", default="gen_potential.py",
                        help='The potential generation script to use (default is "gen_potential.py")')
    parser.add_argument("-d", dest="debug", action="count", default=0,
                        help="Raises screen debug level. -d for INFO alerts, -dd for DEBUG alerts")
    parser.add_argument("--version", action="version", version=__version__)
    args = parser.parse_args(argv)

    # multi-host entry: no-op unless WAFER_COORDINATOR is set; must run
    # before any JAX backend initialises (parallel/distributed.py)
    from wavefarm.parallel.distributed import maybe_initialize_distributed

    maybe_initialize_distributed()

    try:
        config = Config.load(args.config, script=args.script)
    except errors.WaferError as err:
        print(f"Error loading configuration: {err}")
        cause = err.__cause__
        while cause is not None:
            print(f"caused by: {cause}")
            cause = cause.__cause__
        return 1

    # dtype policy must be fixed before any jax computation
    import jax

    from wavefarm.utils.runtime import setup_compile_cache

    setup_compile_cache()

    # x64 is always enabled: f64 runs use it everywhere, f32 runs keep f32
    # arrays but accumulate the per-chunk observables in f64 (see
    # ops/observables.py) so 1e-6 convergence tests stay meaningful.
    jax.config.update("jax_enable_x64", True)
    if config.debug_nans:
        # runtime numeric sanitizer — counterpart of the reference's
        # noisy_float NaN panics (R64 used throughout, src/config.rs:19-22)
        jax.config.update("jax_debug_nans", True)

    log_location = run_dir.get_project_dir(config.project_name, config.output_root) + "/simulation.log"
    try:
        log = wlog.setup_logging(log_location, args.debug)
    except errors.WaferError as err:
        print(f"Error initialising log file: {err}")
        return 1

    log.info("Starting Wafer solver (version %s)", __version__)
    if args.debug > 0:
        log.warning("Debugging information displayed on screen. Progress bar hidden.")
    log.info("Checking/creating directories")
    try:
        run_dir.check_input_dir(config.input_dir)
    except errors.WaferError as err:
        log.critical("%s", err)
        return 1

    term_width = terminal.get_term_size()
    sha = terminal.git_sha(short=term_width <= 97)
    n_devices = len(jax.devices())
    kind = jax.devices()[0].platform
    terminal.print_banner(sha, n_devices, kind)

    log.info("Loading Configuation from disk")
    config.print(term_width)

    debug_level = wlog.screen_level_as_usize(args.debug)

    def progress_factory(wnum):
        if debug_level == 3:
            return terminal.ProgressBar(enabled=True)
        return None

    from wavefarm import solver

    try:
        # solver.run owns the dispatch (multigrid ladder, sharded driver,
        # split-complex) — the CLI must not shortcut it
        runner = lambda: solver.run(  # noqa: E731
            config, log, debug_level, progress_factory=progress_factory
        )
        if config.trace_dir:
            with jax.profiler.trace(config.trace_dir):
                runner()
        else:
            runner()
    except errors.WaferError as err:
        log.critical("%s", err)
        cause = err.__cause__
        while cause is not None:
            log.critical("caused by: %s", cause)
            cause = cause.__cause__
        return 1

    print(_format_elapsed(time.time() - start_time))
    log.info("Simulation completed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
