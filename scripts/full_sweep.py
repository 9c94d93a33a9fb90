#!/usr/bin/env python3
"""Full committed-evidence sweep (round 5).

Enumerates EVERY committed synthetic cell under the reference's
``Data/Experiments`` tree (``<Model>/<Tri>/<depth>cm Depth/<Shape>/<mov>/<rep>``,
1,612 journals across 10 models -- Drunkard excluded: its real-image runs
need dataset images absent from this environment, see BASELINE.md), runs the
same condition through the simulation pipeline, and maintains a cell-by-cell
comparison CSV plus a per-stratum summary.

Resumable: cells whose output journal already parses are skipped, so the
sweep can be interrupted/restarted and committed incrementally.

Usage:
  PYTHONPATH=. python scripts/full_sweep.py \
      --out results/full_sweep [--models ARAP ...] [--limit N]
"""

import argparse
import dataclasses
import os
import re
import sys
import time
import traceback

REF_ROOT = "/root/reference/Data/Experiments"
DB_ROOT = "/root/reference/Data/SinteticDataBase"

# Unscored-in-r4 models first so partial progress maximizes new coverage.
MODEL_ORDER = [
    "ARAP_OneSet",
    "ARAP_depth_1mm",
    "ARAP_depth_8mm",
    "ARAP_not_scaled_depth",
    "ARAP_depth_onlyTriang",
    "ARAP",
    "Elastic",
    "HyperElasticOdgen",
    "ARAP_NoGlobal",
    "ARAP_depth_3mm",
]

MOVEMENT_TYPES = {
    "2_5 mm gaussian": 1,
    "2_5 mm rigid": 2,
    "2_5 mm gaussian + rigid": 3,
    "10 mm gaussian": 4,
    "10 mm rigid": 5,
    "10 mm gaussian + rigid": 6,
}

CELL_RE = re.compile(
    r"^(?P<model>[^/]+)/(?P<tri>InRays|TwoPoints|FarPoints)/"
    r"(?P<depth>\d+)cm Depth/(?P<shape>Planar|Gradual)/"
    r"(?P<mov>[^/]+)/(?P<rep>\d+)/Experiment\.txt$"
)


def committed_cells(ref_root=REF_ROOT):
    """Yield SweepCondition for every committed synthetic journal."""
    from triangulation_in_deformable_scenes_tpu.harness import SweepCondition

    cells = []
    for model in sorted(os.listdir(ref_root)):
        if model == "Drunkard":
            continue
        for dirpath, _dirnames, filenames in os.walk(os.path.join(ref_root, model)):
            if "Experiment.txt" not in filenames:
                continue
            rel = os.path.relpath(os.path.join(dirpath, "Experiment.txt"), ref_root)
            m = CELL_RE.match(rel.replace(os.sep, "/"))
            if not m:  # e.g. Drunkard-style layouts inside a synthetic model
                continue
            etype = MOVEMENT_TYPES.get(m.group("mov"))
            if etype is None:
                continue
            cells.append(
                SweepCondition(
                    m.group("model"),
                    m.group("tri"),
                    int(m.group("depth")),
                    m.group("shape"),
                    etype,
                    int(m.group("rep")),
                )
            )
    order = {m: i for i, m in enumerate(MODEL_ORDER)}
    # Group by (model, tri) to maximize jit-cache reuse between cells.
    cells.sort(
        key=lambda c: (
            order.get(c.model, 99),
            c.triangulation,
            c.depth_cm,
            c.shape,
            c.experiment_type,
            c.experiment,
        )
    )
    return cells


def journal_done(path):
    if not os.path.exists(path):
        return False
    try:
        from triangulation_in_deformable_scenes_tpu.utils.journal import parse_journal

        blocks = parse_journal(path)
        return "FINAL" in blocks and "INITIAL" in blocks
    except Exception:
        return False


def write_summary(out_csv, compare_csv):
    """Per-(model, depth, movement-kind) win tallies from the comparison CSV."""
    import csv
    from collections import defaultdict

    # wins, cells, ours_final, ref_final, ours_init, ref_init
    tally = defaultdict(lambda: [0, 0, 0.0, 0.0, 0.0, 0.0])
    with open(compare_csv) as f:
        for row in csv.DictReader(f):
            gaussian = float(row["Gaussian Mov"])
            kind = "rigid" if gaussian == 0 else "nonrigid"
            key = (row["Model"], row["Depth (cm)"], kind)
            t = tally[key]
            t[0] += int(row["Win"])
            t[1] += 1
            t[2] += float(row["Ours Final (mm)"])
            t[3] += float(row["Ref Final (mm)"])
            t[4] += float(row["Ours Initial (mm)"])
            t[5] += float(row["Ref Initial (mm)"])
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        # The initial columns document committed-config drift: strata whose
        # committed initials do not match ours were generated by historical
        # configurations the reference never committed (its sweep scripts
        # rewrite the YAML per run); the depth-named models' configs are
        # decodable from their names and match to <0.1 mm.
        w.writerow(["Model", "Depth (cm)", "Kind", "Wins", "Cells",
                    "Ours Mean Final (mm)", "Ref Mean Final (mm)",
                    "Ours Mean Initial (mm)", "Ref Mean Initial (mm)"])
        for key in sorted(tally):
            wins, n, so, sr, io, ir = tally[key]
            w.writerow([key[0], key[1], key[2], wins, n,
                        f"{so / n:.3f}", f"{sr / n:.3f}",
                        f"{io / n:.3f}", f"{ir / n:.3f}"])
    return out_csv


def regenerate_compare(out_root, compare_csv, summary_csv):
    from triangulation_in_deformable_scenes_tpu.harness import write_comparison_csv

    path, n_cells, n_wins = write_comparison_csv(
        compare_csv,
        out_root,
        REF_ROOT,
        models=MODEL_ORDER,
        triangulations=["InRays", "TwoPoints", "FarPoints"],
        shapes=("Planar", "Gradual"),
        depth_cms=(20, 80, 150),
        experiment_types=(1, 2, 3, 4, 5, 6),
        experiments=(1, 2, 3, 4, 5),
    )
    write_summary(summary_csv, path)
    return n_cells, n_wins


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/full_sweep")
    ap.add_argument("--compare", default="results/full_compare.csv")
    ap.add_argument("--summary", default="results/full_compare_summary.csv")
    ap.add_argument("--models", nargs="+", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--nlopt-evals", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-every", type=int, default=50)
    args = ap.parse_args()

    from triangulation_in_deformable_scenes_tpu.config import load_config
    from triangulation_in_deformable_scenes_tpu.harness import run_sweep

    base = load_config("/root/reference/Data/Simulation.yaml")
    base = dataclasses.replace(
        base,
        n_optimizations=args.rounds,
        nlopt_n_optimizations=args.nlopt_evals,
    )

    cells = committed_cells()
    if args.models:
        cells = [c for c in cells if c.model in args.models]
    todo = [
        c
        for c in cells
        if not journal_done(os.path.join(args.out, c.result_dir, "Experiment.txt"))
    ]
    if args.limit:
        todo = todo[: args.limit]
    print(f"{len(cells)} committed cells, {len(todo)} to run", flush=True)

    t_start = time.time()
    failures = []
    for i, cond in enumerate(todo):
        t0 = time.time()
        try:
            res = run_sweep(
                base, [cond], args.out, database_root=DB_ROOT, seed=args.seed
            )
            r = res[0][1]
            msg = f"err {r.initial.av_error * 1000:.2f} -> {r.final.av_error * 1000:.2f} mm"
        except Exception:
            failures.append(cond)
            msg = "FAILED\n" + traceback.format_exc(limit=3)
        dt = time.time() - t0
        el = time.time() - t_start
        print(
            f"[{i + 1}/{len(todo)} {el / 60:.1f}min] {cond.result_dir}: {msg} ({dt:.1f}s)",
            flush=True,
        )
        if (i + 1) % args.compare_every == 0:
            n_cells, n_wins = regenerate_compare(args.out, args.compare, args.summary)
            print(f"  == compare: {n_wins}/{n_cells} wins ==", flush=True)

    n_cells, n_wins = regenerate_compare(args.out, args.compare, args.summary)
    print(f"DONE: {n_wins}/{n_cells} wins, {len(failures)} failures", flush=True)
    for c in failures:
        print(f"  failed: {c.result_dir}", flush=True)
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
