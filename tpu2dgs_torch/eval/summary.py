"""One table of the per-scene results (port of scripts/summary.py, without
pandas).

    python3 -m tpu2dgs_torch.eval.summary -o <output_path>

For each scene directory under the output path (sorted): the image metrics
of cli.metrics' results.json (of the method with the highest iteration,
`ours_<iteration>`; a metric that is null is left out), the numbers of a
flat results.json (eval.dtu_scene's Chamfer) and eval.tnt_scene's f1.json.
One row a scene, one column a key in the order keys first appear, and a
mean row over each numeric column's present values; numbers at 4
decimals, a missing value as NaN. Runs on the host only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def latest_method(results: dict) -> str:
    """The method with the highest iteration (`ours_30000` over
    `ours_7000`), by name where none has one."""
    def key(name):
        m = re.search(r"(\d+)$", name)
        return (int(m.group(1)) if m else -1, name)

    return max(results, key=key)


def collect(output_path: str) -> dict[str, dict]:
    """{scene: {key: value}} of every scene directory that holds a result."""
    rows = {}
    for scene in sorted(os.listdir(output_path)):
        scene_dir = os.path.join(output_path, scene)
        if not os.path.isdir(scene_dir):
            continue
        row = {}
        res = os.path.join(scene_dir, "results.json")
        if os.path.exists(res):
            with open(res) as f:
                results = json.load(f)
            if results and isinstance(next(iter(results.values())), dict):
                # image metrics keyed by method (ours_30000 ...)
                row.update({k: v for k, v in results[latest_method(results)].items()
                            if v is not None})
            else:
                row.update({k: v for k, v in results.items() if isinstance(v, (int, float))})
        f1 = os.path.join(scene_dir, "f1.json")
        if os.path.exists(f1):
            with open(f1) as f:
                row.update(json.load(f))
        if row:
            rows[scene] = row
    return rows


def table(rows: dict[str, dict]) -> tuple[list[str], dict[str, dict]]:
    """(columns, rows with a "mean" row added): the mean over each column
    whose present values are all numbers, NaN where a column has none."""
    columns = list(dict.fromkeys(k for row in rows.values() for k in row))
    mean = {}
    for c in columns:
        vals = [row[c] for row in rows.values() if c in row]
        mean[c] = (sum(vals) / len(vals) if vals and all(_is_number(v) for v in vals)
                   else math.nan)
    return columns, {**rows, "mean": mean}


def format_table(columns: list[str], rows: dict[str, dict]) -> str:
    def cell(v) -> str:
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return "NaN"
        return f"{v:.4f}" if _is_number(v) else str(v)

    cells = {name: [cell(row.get(c)) for c in columns] for name, row in rows.items()}
    index_w = max(len(name) for name in rows)
    widths = [max(len(c), *(len(r[i]) for r in cells.values())) for i, c in enumerate(columns)]
    lines = [" " * index_w + "".join(f"  {c:>{w}}" for c, w in zip(columns, widths))]
    for name, row in cells.items():
        lines.append(f"{name:<{index_w}}" + "".join(f"  {v:>{w}}" for v, w in zip(row, widths)))
    return "\n".join(lines)


def main(argv=None, device=None) -> dict[str, dict]:
    """Print the table; return its rows, the mean row last ({} if none)."""
    del device  # host only
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_path", "-o", required=True)
    args = parser.parse_args(argv)
    rows = collect(args.output_path)
    if not rows:
        print("no results found")
        return {}
    columns, rows = table(rows)
    print(format_table(columns, rows))
    return rows


if __name__ == "__main__":
    main()
