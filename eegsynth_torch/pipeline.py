"""One-command end-to-end TimeGAN workflow: raw CSVs → preprocessed buckets →
trained models → (optional long-horizon) synthesis → evaluation → fatigue
t-tests → cluster figures. The CLI of ``scripts/pipeline.py``, with
``--device`` where the script has ``--platform``.

Every stage is a subprocess of one of this package's CLIs, run against one
``--work_dir``, in this order:

    preprocess  python -m eegsynth_torch.preprocess
    train       python -m eegsynth_torch.train.timegan (--parallel_buckets
                unless --sequential)
    synth       python -m eegsynth_torch.generate_long_synth (with --gen_seconds
                or --gen_len)
    eval        python -m eegsynth_torch.eval.drivers --by_condition --tsne_max N
    fatigue     python -m eegsynth_torch.fatigue_report ttest --export-csv
    viz         python -m eegsynth_torch.visualization

``--device`` (``cuda``, the default, or ``cpu``) goes to every stage. A
stage whose key artifact exists is skipped unless ``--force``; a failed
stage fails the run. ``pipeline_manifest.json`` records each stage's status
and seconds and the global eval row.

Examples:
    python -m eegsynth_torch.pipeline --raw_root ./6s_window --work_dir runs/exp1
    python -m eegsynth_torch.pipeline --data_dir ./preprocessed --work_dir runs/exp2 \\
        --sequential --gen_seconds 60 --denorm --zooms
    python -m eegsynth_torch.pipeline ... --stage-arg eval:--tsne_max=2000 \\
        --stage-arg train:--chunk=250
"""

from __future__ import annotations

import argparse
import csv
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

STAGE_ORDER = ("preprocess", "train", "synth", "eval", "fatigue", "viz")
RUN_RE = re.compile(r"posture\d+_(no|with)_exo$")


def _stage_args(pairs: list[str]) -> dict:
    """--stage-arg STAGE:FLAG[=VALUE] → {stage: [flag, value, ...]}."""
    out: dict = {s: [] for s in STAGE_ORDER}
    for item in pairs:
        stage, sep, rest = item.partition(":")
        if not sep or stage not in out:
            raise SystemExit(f"--stage-arg must be one of {STAGE_ORDER} + "
                             f"':FLAG[=VALUE]', got {item!r}")
        flag, sep, val = rest.partition("=")
        out[stage].append(flag)
        if sep:
            out[stage].append(val)
    return out


def _run(cmd: list[str]) -> float:
    """Run one stage (output and environment inherited, cwd the repository
    root so ``-m eegsynth_torch...`` resolves); returns its wall seconds."""
    print(f"\n$ {' '.join(cmd)}", flush=True)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"stage exited {r.returncode}")
    return dt


def _buckets(data_dir: Path) -> list[Path]:
    return sorted(data_dir.glob("posture*_*.npz"))


def _link(src: Path, dst: Path) -> None:
    dst.parent.mkdir(parents=True, exist_ok=True)
    if dst.is_symlink() or dst.exists():
        dst.unlink()
    dst.symlink_to(src.resolve())


def build_fatigue_view(data_dir: Path, runs_dir: Path, view: Path) -> int:
    """The fatigue tools' root/{real,synthetic}/posture{p}_{cond}.npz layout
    as symlinks: real = the preprocessed buckets, synthetic = each run's
    synthetic_long.npz (preferred) or synthetic.npz. Returns the number of
    synthetic links."""
    for fp in _buckets(data_dir):
        _link(fp, view / "real" / fp.name)
    n = 0
    for run in sorted(runs_dir.iterdir()) if runs_dir.is_dir() else []:
        if not (run.is_dir() and RUN_RE.match(run.name)):
            continue
        for cand in ("synthetic_long.npz", "synthetic.npz"):
            if (run / cand).exists():
                _link(run / cand, view / "synthetic" / f"{run.name}.npz")
                n += 1
                break
    return n


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--work_dir", required=True,
                    help="all stage outputs land under this directory")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--raw_root", help="raw CSV tree (protocol_outputs_*) — "
                                        "enables the preprocess stage")
    src.add_argument("--data_dir", help="existing preprocessed NPZ dir — "
                                        "skips the preprocess stage")
    ap.add_argument("--config", default=None,
                    help="training config JSON (configs/timegan_config.json schema)")
    ap.add_argument("--stages", default=None,
                    help=f"comma list from {','.join(STAGE_ORDER)} (default: all applicable)")
    ap.add_argument("--force", action="store_true",
                    help="re-run stages whose artifacts already exist")
    ap.add_argument("--dry_run", action="store_true",
                    help="print the stage plan and exit")
    ap.add_argument("--sequential", action="store_true",
                    help="per-bucket training loop instead of the stacked "
                         "--parallel_buckets default")
    ap.add_argument("--mesh", action="store_true",
                    help="refused: no device mesh in eegsynth_torch")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where every stage runs")
    ap.add_argument("--gen_seconds", type=float, default=None)
    ap.add_argument("--gen_len", type=int, default=None)
    ap.add_argument("--n", type=int, default=None,
                    help="synthetic sequences per run (default: real count)")
    ap.add_argument("--denorm", action="store_true")
    ap.add_argument("--prefer_latest", action="store_true",
                    help="synthesize from ckpt_latest instead of ckpt_best")
    ap.add_argument("--tsne_max", type=int, default=6000)
    ap.add_argument("--color_scheme", choices=["36", "18"], default="36")
    ap.add_argument("--zooms", action="store_true")
    ap.add_argument("--scaling", choices=["none", "p95", "median"], default="none",
                    help="fatigue t-test display scaling variant")
    ap.add_argument("--stage-arg", action="append", default=[],
                    metavar="STAGE:FLAG[=VALUE]",
                    help="forward an arbitrary flag to one stage's CLI (repeatable)")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = _parser().parse_args(argv)
    if args.mesh:
        raise SystemExit("--mesh has no counterpart in eegsynth_torch: the stages "
                         "run on one device (--device)")
    extra = _stage_args(args.stage_arg)
    # stages run with cwd at the repository root: resolve the caller's
    # relative paths now
    work = Path(args.work_dir).resolve()
    work.mkdir(parents=True, exist_ok=True)
    if args.raw_root:
        args.raw_root = str(Path(args.raw_root).resolve())
    if args.config:
        args.config = str(Path(args.config).resolve())
    data_dir = work / "preprocessed" if args.raw_root else Path(args.data_dir).resolve()
    runs_dir = work / "timegan_runs"
    eval_dir = work / "eval_out"
    fatigue_dir = work / "fatigue"
    figs_dir = work / "figures"

    want_synth = args.gen_seconds is not None or args.gen_len is not None
    if args.stages:
        stages = [s.strip() for s in args.stages.split(",") if s.strip()]
        bad = [s for s in stages if s not in STAGE_ORDER]
        if bad:
            raise SystemExit(f"Unknown stage(s) {bad}; valid: {STAGE_ORDER}")
        stages = [s for s in STAGE_ORDER if s in stages]
    else:
        stages = [s for s in STAGE_ORDER
                  if (s != "preprocess" or args.raw_root)
                  and (s != "synth" or want_synth)]
    if "preprocess" in stages and not args.raw_root:
        raise SystemExit("the preprocess stage needs --raw_root")
    if "synth" in stages and not want_synth:
        raise SystemExit("the synth stage needs --gen_seconds or --gen_len")

    py = [sys.executable, "-u", "-m"]
    dev = ["--device", args.device]

    def preprocess_cmd():
        return (py + ["eegsynth_torch.preprocess", "--root", args.raw_root,
                      "--out", str(data_dir)] + dev + extra["preprocess"])

    def train_cmd():
        cmd = py + ["eegsynth_torch.train.timegan", "--data_dir", str(data_dir),
                    "--out_dir", str(runs_dir)]
        if args.config:
            cmd += ["--config", args.config]
        if not args.sequential:
            cmd += ["--parallel_buckets"]
        return cmd + dev + extra["train"]

    def synth_cmd():
        cmd = py + ["eegsynth_torch.generate_long_synth", "--runs_dir",
                    str(runs_dir), "--real_dir", str(data_dir)]
        if args.gen_seconds is not None:
            cmd += ["--gen_seconds", str(args.gen_seconds)]
        if args.gen_len is not None:
            cmd += ["--gen_len", str(args.gen_len)]
        if args.n is not None:
            cmd += ["--n", str(args.n)]
        if args.denorm:
            cmd += ["--denorm"]
        if args.prefer_latest:
            cmd += ["--prefer_latest"]
        return cmd + dev + extra["synth"]

    def eval_cmd():
        return (py + ["eegsynth_torch.eval.drivers", "--real_dir", str(data_dir),
                      "--synth_dir", str(runs_dir), "--out", str(eval_dir),
                      "--by_condition", "--tsne_max", str(args.tsne_max)]
                + dev + extra["eval"])

    def fatigue_cmd():
        view = work / "fatigue_view"
        if build_fatigue_view(data_dir, runs_dir, view) == 0:
            raise RuntimeError(f"no synthetic NPZs under {runs_dir} — run the "
                               "train stage first")
        cmd = py + ["eegsynth_torch.fatigue_report", "ttest", "--root", str(view),
                    "--out", str(fatigue_dir), "--export-csv"]
        if args.scaling != "none":
            cmd += ["--scaling", args.scaling]
        return cmd + dev + extra["fatigue"]

    def viz_cmd():
        cmd = py + ["eegsynth_torch.visualization", "--real_dir", str(data_dir),
                    "--synth_dir", str(runs_dir), "--out", str(figs_dir),
                    "--color_scheme", args.color_scheme,
                    "--tsne_max", str(args.tsne_max)]
        if args.zooms:
            cmd += ["--zooms"]
        return cmd + dev + extra["viz"]

    def have_runs():
        bs = _buckets(data_dir)
        return bool(bs) and all((runs_dir / f.stem / "synthetic.npz").exists()
                                for f in bs)

    done_when = {
        "preprocess": lambda: (data_dir / "prep_index.csv").exists(),
        "train": have_runs,
        "synth": lambda: have_runs() and all(
            (runs_dir / f.stem / "synthetic_long.npz").exists()
            for f in _buckets(data_dir)),
        "eval": lambda: (eval_dir / "metrics_global.csv").exists(),
        "fatigue": lambda: any(fatigue_dir.glob("posture*_tbr_4group.png")),
        "viz": lambda: (figs_dir / "pca_combined.png").exists(),
    }
    cmds = {"preprocess": preprocess_cmd, "train": train_cmd, "synth": synth_cmd,
            "eval": eval_cmd, "fatigue": fatigue_cmd, "viz": viz_cmd}

    manifest = {"work_dir": str(work), "data_dir": str(data_dir),
                "argv": sys.argv[1:] if argv is None else list(argv), "stages": {}}
    print(f"Pipeline plan: {' → '.join(stages)}  (work_dir={work})", flush=True)
    if args.dry_run:
        for s in stages:
            state = "skip (artifacts exist)" if not args.force and done_when[s]() else "run"
            print(f"  {s}: {state}")
        return

    t_total = time.perf_counter()
    for s in stages:
        if not args.force and done_when[s]():
            print(f"\n== [{s}] SKIP — artifacts exist (use --force to re-run)", flush=True)
            manifest["stages"][s] = {"status": "skipped"}
            continue
        print(f"\n== [{s}] ==", flush=True)
        try:
            dt = _run(cmds[s]())
        except Exception as e:
            manifest["stages"][s] = {"status": "failed", "error": str(e)}
            (work / "pipeline_manifest.json").write_text(json.dumps(manifest, indent=2))
            raise SystemExit(f"[pipeline] stage '{s}' failed: {e}")
        manifest["stages"][s] = {"status": "ok", "seconds": round(dt, 2)}
        print(f"== [{s}] done in {dt:.1f}s", flush=True)

    gm = eval_dir / "metrics_global.csv"
    if gm.exists():
        with open(gm) as f:
            rows = list(csv.DictReader(f))
        if rows:
            manifest["eval_global"] = {k: (float(v) if v not in ("", None) else None)
                                       for k, v in rows[0].items()}
    manifest["total_seconds"] = round(time.perf_counter() - t_total, 2)
    (work / "pipeline_manifest.json").write_text(json.dumps(manifest, indent=2))
    print(f"\nPipeline complete in {manifest['total_seconds']}s — manifest at "
          f"{work / 'pipeline_manifest.json'}", flush=True)


if __name__ == "__main__":
    main()
