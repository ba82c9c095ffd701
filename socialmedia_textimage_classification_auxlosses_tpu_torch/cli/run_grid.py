"""Paper-grid runner: the task x seed x aux-loss grid of runner invocations
and the mean±std tables built from their metric CSVs, on CUDA.

Counterpart of the JAX package's ``cli/run_grid.py``, with the same flags,
plan, artifact paths and tables, for every runner family: ``mm_late``
(``run_mm_late``), ``mm_early`` with ``vilt``, ``lxmert`` or ``mmbt``
(``run_mm_early``; MMBT's artifacts under ``results_dir_mmbt``), ``txt``
(``run_txt``) and ``img`` (``run_img``)::

    python -m socialmedia_textimage_classification_auxlosses_tpu_torch.cli.run_grid \\
        --families mm_late --mm_late bernice-vit-attention \\
        --tasks 2,3 --seeds 30,40,50 --aux none,itc,itm,itc+itm \\
        --epochs 7 --out results/grid/ -- --steps_per_dispatch 8

Everything after a literal ``--`` goes verbatim to every runner (``--arch``,
``--dtype``, ``--attn_impl``, ``--testing``, ``--device`` ...). A run whose
metric CSVs exist is skipped unless ``--force``; ``--aggregate_only``
rebuilds the tables from existing artifacts; ``--dry_run`` prints the plan.
Runs execute in this process. ``--seed_backend vmap`` runs each ``mm_late``
configuration's pending seeds as one seed-stacked sweep (``run_seed_sweep``,
independent per-seed data, the same artifact names); other families (the
early-fusion models among them), single seeds and flag sets the sweep
refuses run one by one, as in the JAX package.

The aggregate: for each run, the test column of the epoch with the best
validation macro-F1 (``--select best_val``) or of the last epoch (``last``);
per (family, model, aux, task) the mean, standard deviation (n - 1) and
count over seeds. ``grid_runs.csv``, ``grid_table_<metric>.csv`` and
``grid_table_<metric>.md`` are written with ``csv`` (no pandas), in the
JAX package's columns, number formats and markdown text.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import math
import os
import traceback

from ..core import config as C
from ..utils.logging import get_logger

logger = get_logger(__name__)

FAMILIES = ("txt", "img", "mm_late", "mm_early")
AUX_SETTINGS = {  # token -> (use_clip_loss, use_tim_loss)
    "none": (False, False),
    "itc": (True, False),
    "itm": (False, True),
    "itc+itm": (True, True),
}
GROUP = ("family", "model", "aux", "task")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="paper-grid runner: task x seed x aux-loss across the runner families")
    parser.add_argument("--families", type=str, default="mm_late",
                        help="comma list from {txt,img,mm_late,mm_early}")
    parser.add_argument("--tasks", type=str, default="2",
                        help="comma list of task ids (core.config.TASKS)")
    parser.add_argument("--seeds", type=str, default="30,40,50",
                        help="comma list of seeds: N independent runs per config, the "
                             "paper's protocol")
    parser.add_argument("--aux", type=str, default="none,itc,itm,itc+itm",
                        help="comma list from {none,itc,itm,itc+itm}; applies to "
                             "mm_late/mm_early only")
    parser.add_argument("--txt", type=str, default="bernice",
                        help="comma list of text-only models")
    parser.add_argument("--img", type=str, default="vit",
                        help="comma list of image-only models")
    parser.add_argument("--mm_late", type=str, default="bernice-vit-attention",
                        help="comma list of txt-img-fusion triples")
    parser.add_argument("--mm_early", type=str, default="vilt",
                        help="comma list from {vilt,lxmert,mmbt}")
    parser.add_argument("--epochs", type=int, default=7)
    parser.add_argument("--beta_itc", type=float, default=0.1)
    parser.add_argument("--beta_itm", type=float, default=0.1)
    parser.add_argument("--out", type=str, default=None,
                        help="table output dir (default {RES_PATH}grid/)")
    parser.add_argument("--select", type=str, default="best_val",
                        choices=["best_val", "last"],
                        help="which epoch's test metrics represent a run")
    parser.add_argument("--metrics", type=str, default="f1_macro,f1_weighted",
                        help="metrics to emit one markdown table each for")
    parser.add_argument("--seed_backend", default="sequential",
                        choices=["sequential", "vmap"],
                        help="vmap: run each mm_late config's seeds as ONE seed-stacked "
                             "sweep (cli/run_seed_sweep, independent per-seed data, the "
                             "same artifact names); other families and flag sets the "
                             "sweep refuses run sequentially")
    parser.add_argument("--force", action="store_true",
                        help="re-run even if the run's metrics CSV exists")
    parser.add_argument("--dry_run", action="store_true",
                        help="print the run plan and exit")
    parser.add_argument("--aggregate_only", action="store_true",
                        help="skip running; rebuild tables from artifacts")
    parser.add_argument("runner_args", nargs=argparse.REMAINDER,
                        help="args after -- go verbatim to every runner")
    args = parser.parse_args(argv)
    if args.runner_args and args.runner_args[0] == "--":
        args.runner_args = args.runner_args[1:]
    for fam in _csv(args.families):
        if fam not in FAMILIES:
            parser.error(f"unknown family {fam!r} (choose from {FAMILIES})")
    for tok in _csv(args.aux):
        if tok not in AUX_SETTINGS:
            parser.error(f"unknown aux setting {tok!r} (choose from {sorted(AUX_SETTINGS)})")
    return args


def _csv(s):
    return [t for t in str(s).split(",") if t]


class Run:
    """One grid cell: a single runner invocation + its artifact locations."""

    def __init__(self, family, model, task, seed, aux, args):
        self.family, self.model, self.task = family, model, int(task)
        self.seed, self.aux = int(seed), aux
        use_itc, use_itm = AUX_SETTINGS[aux]
        self.argv = ["--task", str(task), "--seed", str(seed), "--epochs", str(args.epochs)]
        if family in ("mm_late", "mm_early"):
            if use_itc:
                self.argv += ["--use_clip_loss", "--beta_itc", str(args.beta_itc)]
            if use_itm:
                self.argv += ["--use_tim_loss", "--beta_itm", str(args.beta_itm)]
        if family == "mm_late":
            txt, img, fusion = model.split("-", 2)
            self.argv += ["--txt_model_name", txt, "--img_model_name", img,
                          "--fusion_name", fusion]
        elif family == "mm_early":
            self.argv += ["--model", model]
        else:
            self.argv += ["--model_name", model]
        self.argv += list(args.runner_args)
        # the paths come from the runner's own parse of this argv and the
        # shared naming contract, so flags that change names cannot drift
        self.val_csv, self.test_csv = self._artifact_paths(family, model)

    def _artifact_paths(self, family, model):
        from . import run_img, run_mm_early, run_mm_late, run_txt
        from ._common import artifact_stem

        parser = {"txt": run_txt, "img": run_img, "mm_late": run_mm_late,
                  "mm_early": run_mm_early}[family]
        ns = parser.parse_args(self.argv)
        if family in ("txt", "img"):
            base = C.results_dir_txt if family == "txt" else C.results_dir_img
            stem = f"{ns.model_name}_task{ns.task}_seed{ns.seed}_"
        elif family == "mm_late":
            base = C.results_dir_mm_late
            stem = artifact_stem(ns, C.serving_config(ns), "mm_late")
        else:  # MMBT's artifacts live in the reference's results_dir_mmbt
            base = C.results_dir_mmbt if model == "mmbt" else C.results_dir_mm_early
            stem = artifact_stem(ns, C.serving_config(ns, model_name=model), model)
        base += "testing/" if getattr(ns, "testing", False) else ""
        return base + stem + "metrics_val.csv", base + stem + "metrics_test.csv"

    def argv_key(self):
        return tuple(self.argv)

    def done(self) -> bool:
        return os.path.isfile(self.test_csv) and os.path.isfile(self.val_csv)

    def __repr__(self):
        return f"{self.family}:{self.model} task{self.task} seed{self.seed} aux={self.aux}"


def build_plan(args):
    """The grid, deduped: txt and img have no aux-loss axis (the reference's
    text and image runners carry no ITC/ITM flags), so they contribute one
    run per (model, task, seed) whatever ``--aux`` says."""
    plan, seen = [], set()
    for fam in _csv(args.families):
        models = _csv(getattr(args, fam))
        aux_list = _csv(args.aux) if fam in ("mm_late", "mm_early") else ["none"]
        for model, task, aux, seed in itertools.product(
                models, _csv(args.tasks), aux_list, _csv(args.seeds)):
            run = Run(fam, model, task, seed, aux, args)
            dedup = (fam, model, int(task), int(seed), run.argv_key())
            if dedup not in seen:
                seen.add(dedup)
                plan.append(run)
    return plan


def execute(run: Run) -> str:
    """Run the family's runner ``main`` in this process."""
    from . import run_img, run_mm_early, run_mm_late, run_txt

    mains = {"txt": run_txt.main, "img": run_img.main, "mm_late": run_mm_late.main,
             "mm_early": run_mm_early.main}
    try:
        mains[run.family](run.argv)
    except SystemExit as e:  # a runner's refusal or argparse error
        if e.code not in (None, 0):
            logger.error("grid run refused: %s (%s)", run, e.code)
            return f"exit={e.code}"
        return "ok"
    except Exception:  # the grid goes on; the failure is counted and logged
        logger.error("grid run FAILED: %s\n%s", run, traceback.format_exc())
        return "error"
    return "ok"


def _argv_without_seed(argv):
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok == "--seed":
            skip = True
            continue
        out.append(tok)
    return out


def execute_vmap(pending) -> int:
    """``--seed_backend vmap``: each mm_late configuration's pending seeds as
    one ``run_seed_sweep``; other families, single seeds, flag sets the
    sweep refuses and artifacts it did not land run one by one. Returns the
    failure count."""
    from . import run_seed_sweep

    failures = 0
    groups: dict = {}
    for run in pending:
        key = (run.family, run.model, run.task, run.aux, tuple(_argv_without_seed(run.argv)))
        groups.setdefault(key, []).append(run)

    def run_sequentially(runs):
        nonlocal failures
        for run in runs:
            logger.info("RUN (sequential) %s", run)
            if execute(run) != "ok":
                failures += 1

    for runs in groups.values():
        if runs[0].family != "mm_late" or len(runs) < 2:
            run_sequentially(runs)
            continue
        seeds = [r.seed for r in runs]
        argv = _argv_without_seed(runs[0].argv) + ["--seeds", ",".join(map(str, seeds))]
        logger.info("RUN (seed sweep, %d seeds %s): %s", len(seeds), seeds, runs[0])
        try:
            run_seed_sweep.main(argv)
        except SystemExit as e:
            if e.code not in (None, 0):
                logger.warning("the seed sweep refused this flag set (%s); running the "
                               "seeds one by one", e.code)
                run_sequentially(runs)
                continue
        except Exception:  # the grid goes on with the seeds one by one
            logger.error("seed sweep FAILED: %s\n%s", runs[0], traceback.format_exc())
            run_sequentially(runs)
            continue
        stragglers = [r for r in runs if not r.done()]
        if stragglers:
            logger.warning("the seed sweep left %d artifact sets missing; running those "
                           "one by one", len(stragglers))
            run_sequentially(stragglers)
    return failures


# -- aggregation (csv, in the JAX package's pandas formats) ----------------------


def read_metric_table(path):
    """A metrics CSV (metric x epoch, the trainers' contract) as
    ``({metric: {column: value}}, the epoch columns in order)``."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = rows[0]
    epochs = [c for c in header[1:] if c.startswith("epoch-")]
    table = {r[0]: dict(zip(header[1:], r[1:])) for r in rows[1:]}
    return table, epochs


def _float(text: str) -> float:
    return float(text) if text != "" else float("nan")


def select_epoch(val_csv, select):
    """The epoch column that represents a run: the best validation macro-F1
    (its first maximum), or the last."""
    val, epochs = read_metric_table(val_csv)
    if select == "last" or "f1_macro" not in val:
        return epochs[-1]
    values = [(_float(val["f1_macro"][e]), e) for e in epochs]
    values = [(v, e) for v, e in values if not math.isnan(v)]
    best = max(v for v, _ in values)
    return next(e for v, e in values if v == best)


def _mean(values):
    """pandas' group mean: a compensated (Kahan) sum over the count."""
    total = comp = 0.0
    for v in values:
        y = v - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total / len(values) if values else float("nan")


def _std(values):
    """pandas' group standard deviation (n - 1), by Welford's update."""
    mean = ssq = 0.0
    for n, v in enumerate(values, 1):
        old = mean
        mean += (v - old) / n
        ssq += (v - mean) * (v - old)
    return math.sqrt(ssq / (len(values) - 1)) if len(values) > 1 else float("nan")


def aggregate(runs, args):
    """Per-run selected-epoch test metrics (the long table, one dict per
    run) and per metric the (family, model, aux, task) rows of mean, std
    and count over the seeds, sorted as pandas' ``groupby`` sorts."""
    records = []
    for run in runs:
        rec = dict(family=run.family, model=run.model, task=run.task, aux=run.aux,
                   seed=run.seed)
        if not run.done():
            records.append(dict(rec, status="missing"))
            continue
        epoch = select_epoch(run.val_csv, args.select)
        test, epochs = read_metric_table(run.test_csv)
        if epoch not in epochs:
            epoch = epochs[-1]
        rec.update(status="ok", sel_epoch=epoch)
        for metric, row in test.items():
            rec[metric] = _float(row[epoch])
        records.append(rec)
    ok = [r for r in records if r["status"] == "ok"]
    tables = {}
    for metric in _csv(args.metrics):
        if not ok or not any(metric in r for r in ok):
            continue
        groups: dict = {}
        for r in ok:
            groups.setdefault(tuple(r[k] for k in GROUP), []).append(r.get(metric, math.nan))
        tables[metric] = []
        for key in sorted(groups):
            values = [v for v in groups[key] if not math.isnan(v)]
            tables[metric].append(dict(zip(GROUP, key), mean=_mean(values), std=_std(values),
                                       count=len(values)))
    return records, tables


def _cell(v) -> str:
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def write_rows(rows, path) -> None:
    """Dict rows as pandas' ``DataFrame(rows).to_csv(index=False)`` writes
    them: the columns in order of first appearance, a missing or NaN value
    empty, floats in their shortest round-trip form."""
    columns = []
    for r in rows:
        columns += [k for k in r if k not in columns]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for r in rows:
            w.writerow([_cell(r[c]) if c in r else "" for c in columns])


def render_markdown(metric, stat, select):
    """The paper's layout: one row per (family, model, aux), one column per
    task, each cell mean ± std (n); the JAX package's text."""
    lines = [f"# {metric} — mean ± std over seeds (epoch selection: {select})", ""]
    tasks = sorted({r["task"] for r in stat})
    header = "| model (family, aux) | " + " | ".join(
        f"task {t} ({C.TASKS[t]})" for t in tasks) + " |"
    lines += [header, "|" + "---|" * (len(tasks) + 1)]
    for fam, model, aux in sorted({(r["family"], r["model"], r["aux"]) for r in stat}):
        label = f"{model} [{fam}]" + ("" if aux == "none" else f" +{aux.upper()}")
        cells = []
        for t in tasks:
            row = [r for r in stat if (r["family"], r["model"], r["aux"], r["task"])
                   == (fam, model, aux, t)]
            if not row:
                cells.append("—")
            else:
                mean, std, n = row[0]["mean"], row[0]["std"], int(row[0]["count"])
                std_s = "" if (n < 2 or math.isnan(std)) else f" ± {std:.4f}"
                cells.append(f"{mean:.4f}{std_s} (n={n})")
        lines.append(f"| {label} | " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    args = parse_args(argv)
    plan = build_plan(args)
    out_dir = args.out or (C.RES_PATH + "grid/")
    logger.info("grid: %d runs -> %s", len(plan), out_dir)
    if args.dry_run:
        for run in plan:
            print(f"{run.family}: {' '.join(run.argv)}")
        return 0

    failures = 0
    if not args.aggregate_only:
        pending = []
        for i, run in enumerate(plan):
            if run.done() and not args.force:
                logger.info("[%d/%d] skip (artifacts exist): %s", i + 1, len(plan), run)
                continue
            pending.append(run)
        if args.seed_backend == "vmap":
            failures = execute_vmap(pending)
        else:
            for i, run in enumerate(pending):
                logger.info("[%d/%d] RUN %s", i + 1, len(pending), run)
                if execute(run) != "ok":
                    failures += 1

    os.makedirs(out_dir, exist_ok=True)
    records, tables = aggregate(plan, args)
    runs_path = os.path.join(out_dir, "grid_runs.csv")
    write_rows(records, runs_path)
    logger.info("%s saved (%d runs)", runs_path, len(records))
    for metric, stat in tables.items():
        write_rows(stat, os.path.join(out_dir, f"grid_table_{metric}.csv"))
        md_path = os.path.join(out_dir, f"grid_table_{metric}.md")
        with open(md_path, "w") as f:
            f.write(render_markdown(metric, stat, args.select))
        logger.info("%s saved", md_path)
    missing = sum(r["status"] != "ok" for r in records)
    if failures or missing:
        logger.warning("grid finished with %d failed runs, %d missing artifact sets",
                       failures, missing)
        return 1
    logger.info("Done!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
