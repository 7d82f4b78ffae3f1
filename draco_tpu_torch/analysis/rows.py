"""The incremental report both audits write (tools/_lowering_common.py's
``run_rows``): each row is rewritten to the report file as soon as it is
done, so an interrupted run keeps the rows it finished."""

from __future__ import annotations

import json
import os
import sys


def run_rows(out_path: str, method: str, named_rows, extra=None) -> dict:
    """Drive ``(name, thunk)`` pairs; each thunk returns a dict with at
    least ``{"ok": bool}``. A thunk that raises makes a failed row with the
    error. Returns the report; ``all_ok`` covers the rows run so far."""
    report = {"method": method, "all_ok": None, "rows": []}
    if extra:
        report.update(extra)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    for name, thunk in named_rows:
        try:
            row = thunk()
        except Exception as e:  # a row's crash must not lose earlier rows
            row = {"ok": False, "error": f"{type(e).__name__}: {str(e)[:400]}"}
        row = {"name": name, **row}
        report["rows"].append(row)
        report["all_ok"] = all(r["ok"] for r in report["rows"])
        write(out_path, report)
        verdict = "ok" if row["ok"] else row.get("error",
                                                 row.get("failed_rules"))
        print(f"[audit] {name}: {verdict}", file=sys.stderr, flush=True)
    return report


def write(path: str, report: dict) -> None:
    """Rewrite ``path`` atomically (tmp + rename)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    os.replace(tmp, path)
