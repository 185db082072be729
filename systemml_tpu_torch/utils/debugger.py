"""Interactive script debugger.

TPU-native equivalent of the reference's DMLDebugger
(debug/DMLDebugger.java — breakpoints, step, frame inspection). Granularity
is the statement block (the unit of compilation here), not the instruction:
`step` executes one ProgramBlock, `b <n>` sets a breakpoint on the n-th
top-level block, `p <var>` prints a symbol-table entry, `whatis <var>`
prints metadata, `c` continues, `q` quits.

Port of systemml_tpu/utils/debugger.py: a matrix prints from its host
copy.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Set

import numpy as np

import torch

from systemml_tpu_torch.runtime.program import (BasicBlock, ExecutionContext,
                                                ForBlock, IfBlock, Program,
                                                ProgramBlock, WhileBlock)


class DMLDebugger:
    PROMPT = "(SystemML-TPU) "

    def __init__(self, program: Program, stdin=None, stdout=None):
        self.program = program
        self.stdin = stdin or sys.stdin
        self.stdout = stdout or sys.stdout
        self.breakpoints: Set[int] = set()
        self.ec = ExecutionContext(program)
        self._stepping = True

    # ---- command loop ----------------------------------------------------

    def run(self):
        self._write("SystemML-TPU debugger. Commands: "
                    "list, b <n>, step|s, c, p <var>, whatis <var>, "
                    "info, q")
        from systemml_tpu_torch.utils import stats as stats_mod

        blocks = self.program.blocks
        i = 0
        with stats_mod.stats_scope(self.program.stats):
            while i < len(blocks):
                if self._stepping or i in self.breakpoints:
                    if not self._interact(i, blocks):
                        return
                blocks[i].execute(self.ec)
                i += 1
        self._write("program finished")

    def _interact(self, i: int, blocks: List[ProgramBlock]) -> bool:
        self._write(f"at block {i}: {_block_label(blocks[i])}")
        while True:
            self.stdout.write(self.PROMPT)
            self.stdout.flush()
            line = self.stdin.readline()
            if not line:
                return False
            cmd, *rest = line.split() or [""]
            if cmd in ("q", "quit"):
                return False
            if cmd in ("s", "step"):
                self._stepping = True
                return True
            if cmd in ("c", "continue", "r", "run"):
                self._stepping = False
                return True
            if cmd == "b" and rest:
                try:
                    self.breakpoints.add(int(rest[0]))
                    self._write(f"breakpoint at block {rest[0]}")
                except ValueError:
                    self._write(f"b expects a block number, got {rest[0]!r}")
            elif cmd in ("list", "l"):
                for j, b in enumerate(blocks):
                    mark = "*" if j in self.breakpoints else " "
                    cur = ">" if j == i else " "
                    self._write(f"{cur}{mark} {j}: {_block_label(b)}")
            elif cmd == "p" and rest:
                self._print_var(rest[0])
            elif cmd == "whatis" and rest:
                self._whatis(rest[0])
            elif cmd == "info":
                names = ", ".join(sorted(self.ec.vars)) or "(empty)"
                self._write(f"symbol table: {names}")
            else:
                self._write(f"unknown command {line.strip()!r}")

    # ---- inspection ------------------------------------------------------

    def _print_var(self, name: str):
        if name not in self.ec.vars:
            self._write(f"undefined variable {name!r}")
            return
        v = self.ec.vars[name]
        if isinstance(v, torch.Tensor):
            self._write(str(v.detach().cpu().numpy()))
        elif hasattr(v, "shape"):
            self._write(str(np.asarray(v)))
        else:
            self._write(repr(v))

    def _whatis(self, name: str):
        if name not in self.ec.vars:
            self._write(f"undefined variable {name!r}")
            return
        v = self.ec.vars[name]
        if hasattr(v, "shape"):
            self._write(f"{name}: matrix {tuple(v.shape)} "
                        f"{str(v.dtype).replace('torch.', '')}")
        else:
            self._write(f"{name}: {type(v).__name__} = {v!r}")

    def _write(self, s: str):
        self.stdout.write(s + "\n")


def _block_label(b: ProgramBlock) -> str:
    if isinstance(b, BasicBlock):
        writes = ",".join(sorted(b.hops.writes)) or "-"
        return f"GENERIC writes=[{writes}]"
    if isinstance(b, IfBlock):
        return "IF"
    if isinstance(b, WhileBlock):
        return "WHILE"
    if isinstance(b, ForBlock):
        return f"FOR ({b.var})"
    return type(b).__name__
