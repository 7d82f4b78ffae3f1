"""The program lint of the port (tools/program_lint.py).

    python -m draco_tpu_torch.analysis.program_lint [--device cpu|cuda]
        [--fast] [--programs NAME|REGEX,...] [--out FILE]

Builds every registered leg (``analysis/registry.py``) through the entry
points a user calls, runs one warm-up step and then one inspected step, and
holds it to its manifest (``analysis/rules.py``); the same for the chunked
programs, a chunk a step (the CPU loop on the CPU, the graph's replays on
the card), with their flush. Then it runs the
seeded-defect controls (``analysis/controls.py``); a control's row is ok
when it trips exactly its rule. ``--fast`` builds the legs at CI size;
without it they run at the width ``chip_smoke.py`` runs them. On the CPU
the card-side rules (constant_bloat, memory_budget) report skipped and the
two card-only controls do not run; on the card every rule and control runs.
The report is rewritten after every row (default
``draco_tpu_torch/_build/audit/program_lint.json``). Exits non-zero when a
program violates its manifest or a control fails to trip.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

from draco_tpu_torch import _build
from draco_tpu_torch.analysis import controls as controls_mod
from draco_tpu_torch.analysis import registry, rules
from draco_tpu_torch.analysis.rows import run_rows

DEFAULT_OUT = str(_build.BUILD_DIR / "audit" / "program_lint.json")


def lint_leg(program) -> dict:
    """One warm-up step through the loop (momentum buffers, plans, kernel
    loads; a chunked program's first chunk, its capture on the card, and
    flush), then the inspected step: the report row."""
    (program.warm or program.runner.step)()
    row, _ = rules.lint_program(program)
    return row


def control_row(control, device) -> dict:
    """A control's row: ok when exactly its rule tripped."""
    row, _ = rules.lint_program(control.build(device))
    tripped = row["failed_rules"]
    live = tripped == [control.expected_fail]
    out = {**row, "ok": live, "expected_fail": control.expected_fail,
           "control": True}
    if not live:
        out["error"] = (f"control must trip exactly [{control.expected_fail}]"
                        f", tripped {tripped}")
    return out


def controls_for(device) -> list:
    """The controls that run on ``device``: the card-only ones need one."""
    import torch

    card = torch.device(device).type == "cuda"
    return [c for c in controls_mod.CONTROLS if card or not c.card_only]


def select(names: str) -> list:
    programs = (registry.collect() + registry.collect_chunks()
                + registry.collect_guard() + registry.collect_autopilot())
    if not names:
        return programs
    keep = set()
    for tok in (t.strip() for t in names.split(",") if t.strip()):
        hits = {p.name for p in programs
                if p.name == tok or re.search(tok, p.name)}
        if not hits:
            raise SystemExit(f"no registered program matches {tok!r}; "
                             f"registered: {[p.name for p in programs]}")
        keep |= hits
    return [p for p in programs if p.name in keep]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fast", action="store_true",
                    help="build the legs at CI size")
    ap.add_argument("--programs", default="",
                    help="comma-separated names or regexes of legs")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    from draco_tpu_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    named = [(p.name, lambda p=p: lint_leg(
        p.build(dev, full=not args.fast))) for p in select(args.programs)]
    named += [(c.name, lambda c=c: control_row(c, dev))
              for c in controls_for(dev)]
    try:
        report = run_rows(
            args.out,
            "one inspected step of each registered leg against its manifest "
            f"({', '.join(rules.RULE_NAMES)}); rows named control_* are "
            "seeded defects whose ok means 'tripped exactly its rule'",
            named, extra={"device": str(dev), "fast": args.fast})
    finally:
        controls_mod.release()
    print(json.dumps({"all_ok": report["all_ok"],
                      "rows": len(report["rows"]), "out": args.out}))
    return 0 if report["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
