"""Command-line entry point.

Port of systemml_tpu/api/cli.py (reference: api/DMLScript.java:127-164
flag surface, :239 main, :659-753 execute):

    python -m systemml_tpu_torch -f script.dml [-args ... | -nvargs k=v ...]
        [-stats [N]] [-explain [hops|runtime]] [-config file.json]
        [-exec auto|single_node] [-seed N] [-python] [-debug] [-trace FILE]
        [-profile [sample|full]]

The run goes through the same compile chain and runtime as MLContext, on
the device of the config (the card unless `-config` names a file whose
JSON sets `"device": "cpu"`). A script's results leave only through its
write() and print() statements (`outputs=()`), so every top-level write
may die at its last use. `-trace FILE` writes the run's flight-recorder
events (obs/trace.py) through obs/export.write: a Chrome trace, or JSON
lines for a FILE ending in `.jsonl`; with `-stats` it also prints the
event-stream summary. `-profile [sample|full]` fences the dispatch sites
(obs/profile.py) and prints the attribution report. `-fault` arms the
parfor.task site (resil/inject.py), and any other site raises, waiting for
distributed and elastic; `-exec mesh` raises at compile
(runtime/program.py), also waiting for distributed and elastic.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

USAGE = "python -m systemml_tpu_torch -f <filename> | -s <script> [options]"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="systemml_tpu_torch", usage=USAGE,
        description="SystemML-TPU, PyTorch port: declarative ML on an "
                    "NVIDIA H100 (DML front end, hand-written CUDA "
                    "kernels)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("-f", dest="file", metavar="FILE",
                     help="DML script file to execute")
    src.add_argument("-s", dest="script", metavar="SCRIPT",
                     help="inline DML script string to execute")
    p.add_argument("-args", dest="args", nargs="*", default=None,
                   metavar="ARG",
                   help="positional script arguments, bound to $1, $2, ...")
    p.add_argument("-nvargs", dest="nvargs", nargs="*", default=None,
                   metavar="K=V",
                   help="named script arguments, bound to $K")
    p.add_argument("-config", dest="config", metavar="FILE",
                   help="JSON config file (reference: SystemML-config.xml)")
    p.add_argument("-stats", dest="stats", nargs="?", const=10, type=int,
                   metavar="N",
                   help="print execution statistics (top-N heavy hitters)")
    p.add_argument("-explain", dest="explain", nargs="?", const="hops",
                   choices=["hops", "runtime"],
                   help="print the compiled plan before execution")
    p.add_argument("-trace", dest="trace", metavar="FILE",
                   help="write this run's flight-recorder events to FILE "
                        "(Chrome-trace JSON; .jsonl: one event a line)")
    p.add_argument("-profile", dest="profile", nargs="?", const="full",
                   choices=["sample", "full"],
                   help="device-time profiling: fence the dispatch sites "
                        "and print the attribution report")
    p.add_argument("-fault", dest="fault", metavar="SPEC",
                   help="fault injection at the parfor.task site "
                        "(other sites wait for ROADMAP queue 1, "
                        "distributed and elastic)")
    p.add_argument("-exec", dest="exec_mode", default=None,
                   choices=["auto", "single_node", "mesh"],
                   help="execution mode (mesh waits for ROADMAP queue 1, "
                        "distributed and elastic)")
    p.add_argument("-debug", dest="debug", action="store_true",
                   help="run under the interactive debugger")
    p.add_argument("-seed", dest="seed", type=int, default=None,
                   help="seed for rand() datagen")
    p.add_argument("-python", dest="pydml", action="store_true",
                   help="parse the script as PyDML (Python-like syntax)")
    return p


def _coerce(v: str):
    """CLI args arrive as strings; numeric and boolean-looking values bind
    typed (the reference types $-args by the expression context they
    appear in)."""
    if v in ("TRUE", "true"):
        return True
    if v in ("FALSE", "false"):
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def parse_script_args(args: Optional[List[str]],
                      nvargs: Optional[List[str]]) -> Dict[str, object]:
    """Binds -args positionally to $1.. and -nvargs K=V to $K (reference:
    DMLOptions, api/DMLScript.java:127-164)."""
    bound: Dict[str, object] = {}
    if args:
        for i, v in enumerate(args, 1):
            bound[str(i)] = _coerce(v)
    if nvargs:
        for kv in nvargs:
            if "=" not in kv:
                raise SystemExit(f"-nvargs expects K=V pairs, got {kv!r}")
            k, v = kv.split("=", 1)
            bound[k] = _coerce(v)
    return bound


def main(argv: Optional[List[str]] = None) -> int:
    ns = build_arg_parser().parse_args(argv)
    from systemml_tpu_torch.utils.config import (DMLConfig,
                                                 apply_matmul_precision,
                                                 check_fault_sites,
                                                 resolve_device, set_config)

    # only the parfor.task site runs in the port: any other raises here
    check_fault_sites(ns.fault)

    cfg = DMLConfig.from_file(ns.config) if ns.config else DMLConfig()
    if ns.exec_mode:
        cfg.exec_mode = ns.exec_mode.upper()
    if ns.stats is not None:
        cfg.stats = True
        cfg.stats_max_heavy_hitters = ns.stats
    if ns.explain:
        cfg.explain = ns.explain
    if ns.fault:
        cfg.fault_injection = ns.fault
    if ns.profile:
        cfg.profile_mode = ns.profile
    resolve_device(cfg)
    set_config(cfg)
    apply_matmul_precision()

    clargs = parse_script_args(ns.args, ns.nvargs)

    from systemml_tpu_torch import obs
    from systemml_tpu_torch.lang.parser import (parse, parse_file,
                                                resolve_imports)
    from systemml_tpu_torch.runtime.program import compile_program

    t0 = time.perf_counter()
    # -trace records the whole run into the flight recorder; -profile
    # without -trace still needs a recorder for attribution: an in-memory
    # one, released before the report is printed
    prof_rec = None
    with obs.traced_run(ns.trace) as recorder:
        if recorder is not None:
            prof_rec = recorder
        elif ns.profile:
            prof_rec = obs.FlightRecorder()
            if not obs.begin_exclusive(prof_rec):
                import warnings

                warnings.warn("another trace is already active; this "
                              "run will not be profiled", RuntimeWarning)
                prof_rec = None
        try:
            with obs.span("parse", obs.CAT_COMPILE,
                          source=ns.file or "<inline>"):
                if ns.pydml:
                    from systemml_tpu_torch.lang.pydml import (
                        parse_pydml, parse_pydml_file)

                    ast_prog = (parse_pydml_file(ns.file) if ns.file
                                else parse_pydml(ns.script))
                elif ns.file:
                    ast_prog = parse_file(ns.file)
                else:
                    ast_prog = parse(ns.script)
                    resolve_imports(ast_prog, ".")

            from systemml_tpu_torch.ops import datagen

            datagen.set_global_seed(ns.seed)  # None clears a prior seed

            with obs.span("compile", obs.CAT_COMPILE):
                # results leave only through write() and print(): nothing
                # is exit-live (the debugger keeps every write: it
                # inspects the symbol table)
                prog = compile_program(ast_prog, clargs=clargs,
                                       outputs=None if ns.debug else ())
            prog.stats.compile_time = time.perf_counter() - t0
            if ns.stats is not None:
                # heavy-hitter times are the ops', not their launches'
                prog.stats.fine_grained = True
            from systemml_tpu_torch.utils.explain import explain_program

            if ns.explain == "hops":
                print(explain_program(prog, mode=ns.explain))
            if ns.debug:
                from systemml_tpu_torch.utils.debugger import DMLDebugger

                DMLDebugger(prog).run()
            else:
                prog.execute()
            if ns.explain == "runtime":
                # after the run: a parfor shows the plan it ran with
                print(explain_program(prog, mode=ns.explain))
        finally:
            # the -profile-only recorder holds the process-global slot
            # with no file to write: release it whatever the run raised
            if prof_rec is not None and prof_rec is not recorder:
                obs.end_exclusive(prof_rec)
        if ns.stats is not None:
            print(prog.stats.display(cfg.stats_max_heavy_hitters))
    if recorder is not None and ns.stats is not None:
        # -stats with -trace also prints the summary of the same events
        # the trace file holds
        print(obs.render_summary(recorder, cfg.stats_max_heavy_hitters))
    if ns.profile and prof_rec is not None:
        print(obs.profile_report(prof_rec).text(
            cfg.stats_max_heavy_hitters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
