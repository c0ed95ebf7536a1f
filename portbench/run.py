"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the start of this process): the
configuration's corpus and the traffic drawn from ``--seed``, the program's
index built through ``Index.add_documents_columnar``, and warm-up passes
over the traffic's warm set through the timed path itself, so the class
shapes and graphs of the traffic exist before it starts (with ``prewarm``
the BM25 template's window graph is captured after the first pass; the
graph counters of the window, its own first sights among them, go to
standard error).  The
measured window then serves the traffic's stream, queries the program has
not seen, in order for ``--seconds`` in the closed loop of ``serve.py``
through ``Index.query_batch_async(...).get_arrays()``; ``--trace 1`` runs it
under ``torch.profiler`` and prints the per-layer metrics instead of the
end-to-end ones.

After the window: the peak device memory is read, the program's state is
freed, and a sample of the rows the window drained (drawn from the seed,
with each window's longest request) is judged against the float64 reference
(``check.py``); each number compared is printed beside its limit, last on
standard error and last in the result line.

Exits 2 without a result when no CUDA device (or fewer than the cell's
chips) is present, and 3 when JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from portbench import check, counts, corpus, manifest, serve  # noqa: E402
from portbench import trace as tr  # noqa: E402
from portbench.reference import ReferenceIndex  # noqa: E402

# Top-level module names that must not be loaded by a run: JAX and the JAX
# package beside the port (compared whole: the port's name begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "probly_search_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip().splitlines()
        return float(out[0].split(",")[-1]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def build(cell: manifest.Cell, data: corpus.Corpus, device: str):
    """The program under test: an index of the corpus, its scorer (the
    ``program`` of the configuration's scorer file) and the timed call."""
    from probly_search_tpu_torch import Index, IndexConfig

    cfg, traffic = cell.config, cell.traffic
    kw = dict(cfg.get("index_config", {}))
    preset = traffic.get("index_preset")
    config = getattr(IndexConfig, preset)(**kw) if preset else IndexConfig(**kw)
    ix = Index(len(data.fields), config=config, device=device)
    ix.add_documents_columnar(list(range(data.n_docs)), data.texts)
    scorer = cell.scorer.program(cell.scorer.spec)
    k = int(cfg["top_k"])

    def submit(queries):
        return ix.query_batch_async(queries, scorer, top_k=k)

    return ix, scorer, submit


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float = T_START) -> dict:
    """Set up, serve the measured window, judge it; returns the result line
    (without the device entry's card facts)."""
    import torch

    from probly_search_tpu_torch.utils.metrics import metrics

    cfg, traffic = cell.config, cell.traffic
    if traffic.get("loop", "closed") != "closed":
        raise ValueError(f"{cell.name}: only closed-loop traffic is served, not {traffic['loop']!r}")
    W, depth = int(traffic["window"]), int(traffic["depth"])
    k = int(cfg["top_k"])
    data = corpus.make_corpus(cfg, seed)
    pool = corpus.make_traffic(cfg, traffic, data, seed)
    n_warm, n_stream = pool.warm, len(pool) - pool.warm
    log(f"[set-up] corpus, {n_warm} warm and {n_stream} stream requests drawn: "
        f"{time.perf_counter() - t_start:.1f} s")
    ix, scorer, submit = build(cell, data, device)
    log(f"[set-up] index built: {time.perf_counter() - t_start:.1f} s")

    def stream_window(wi):
        a = n_warm + wi * W
        if a + W > len(pool):
            raise RuntimeError(f"{cell.name}: the stream's {n_stream} requests ran out at window {wi}")
        return np.arange(a, a + W)

    for p in range(int(traffic["warm_passes"])):
        order = corpus.warm_order(seed, p, n_warm)
        serve.serve(submit, lambda wi: [pool.strings[i] for i in order[wi * W : (wi + 1) * W]],
                    depth, lambda wi, out: None, windows=n_warm // W)
        if p == 0 and traffic.get("prewarm"):
            ix.device_index().prewarm(scorer)
        log(f"[set-up] warm pass {p + 1}: {time.perf_counter() - t_start:.1f} s")
    if device == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    metrics.reset()
    peak_setup = torch.cuda.max_memory_reserved() if device == "cuda" else 0
    log(f"[memory] reserved peak after set-up: {peak_setup} B")

    # Rows kept for the check: a seeded few of every window, and the row of
    # its longest request (most words).
    n_words = np.diff(pool.offsets)
    keep_random = int(traffic.get("rows_per_window", 8))
    kept_random, kept_long, drained_windows = [], [], []
    peak_rises = []  # (window, reserved peak) where the peak rose past the one before

    def note_peak(wi):
        if device == "cuda":
            p = torch.cuda.max_memory_reserved()
            if p > (peak_rises[-1][1] if peak_rises else peak_setup):
                peak_rises.append((wi, p))

    def on_drained(wi, out):
        _, slots, keys = out
        rows = np.where(slots >= 0, keys, -1)
        qidx = stream_window(wi)
        pick = np.random.default_rng([seed, 3, wi]).choice(W, keep_random, replace=False)
        kept_random.extend((int(qidx[r]), rows[r].copy()) for r in pick.tolist())
        r = int(np.argmax(n_words[qidx]))
        kept_long.append((int(qidx[r]), rows[r].copy()))
        drained_windows.append(wi)
        note_peak(wi)

    def next_window(wi):
        return [pool.strings[i] for i in stream_window(wi)]

    setup_s = time.perf_counter() - t_start
    log(f"[window] setup_s {setup_s:.3f}; serving {seconds} s (trace {int(trace)})")
    if trace:
        span_names = tr.Names()
        with tr.profiler() as prof, tr.mark_program_timers(metrics, span_names):
            with span_names.annotate(tr.WINDOW):
                lat, queries, wall = serve.serve(
                    submit, next_window, depth, on_drained, seconds=seconds,
                    annotate=span_names.annotate,
                )
                if device == "cuda":
                    torch.cuda.synchronize()
    else:
        lat, queries, wall = serve.serve(submit, next_window, depth, on_drained, seconds=seconds)
    snap = metrics.snapshot()
    peak = torch.cuda.max_memory_reserved() if device == "cuda" else 0
    counters = {
        name: v for name, v in snap["counters"].items()
        if name.startswith(("class_graph", "template", "device_fallback", "heavy_cache"))
    }
    log(f"[window] {len(lat)} windows, {queries} queries in {wall:.3f} s; counters {counters}")
    log(f"[memory] reserved peak {peak} B, allocated peak "
        f"{torch.cuda.max_memory_allocated() if device == 'cuda' else 0} B; rose after set-up at "
        f"(window, bytes) {peak_rises}")

    trace_summary = None
    if trace:
        t_tr = time.perf_counter()
        trace_summary = tr.reduce(prof, span_names)
        del prof
        log(f"[trace] {trace_summary['n_device_events']} device events reduced in {time.perf_counter() - t_tr:.1f} s")
    del ix, scorer, submit
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # The reference: its own index of the same token ids.
    t_ref = time.perf_counter()
    ref = ReferenceIndex(data.fields, data.n_docs, data.spell, data.spell_len)
    work = None
    log(f"[check] reference index: {time.perf_counter() - t_ref:.1f} s")
    if trace:
        wc = counts.WorkCounter(ref, data)
        log(f"[work] postings per term: {time.perf_counter() - t_ref:.1f} s")
        served = np.concatenate([stream_window(wi) for wi in drained_windows])
        postings = wc.query_postings(pool, data, served)
        log(f"[work] postings per request: {time.perf_counter() - t_ref:.1f} s")
        nbytes, ops = counts.window_work(postings, len(data.fields), k, cell.scorer)
        least, bound = counts.least_seconds(nbytes, ops)
        work = {"least_s": least, "bound": bound, "bytes": nbytes, "ops": ops}
        log(f"[work] {len(drained_windows)} windows: {nbytes:.6g} B, {ops:.6g} ops, least {least:.6g} s ({bound})")

    rng = np.random.default_rng([seed, 4])
    n_rows = min(int(traffic["check_rows"]), len(kept_random))
    sample = [kept_random[i] for i in sorted(rng.choice(len(kept_random), n_rows, replace=False).tolist())]
    kept_long.sort(key=lambda x: -n_words[x[0]])
    sample += kept_long[: int(traffic["check_longest"])]
    numbers = check.judge(
        ref, cell.scorer, [pool.words(data, qi) for qi, _ in sample], [row for _, row in sample], k
    )
    checks = check.verdict(numbers, cfg["check"]["limits"])
    log(f"[check] {numbers} in {time.perf_counter() - t_ref:.1f} s")

    ctx = {
        "timed": {"latencies_s": lat, "queries": queries, "wall_s": wall, "setup_s": setup_s, "peak_bytes": peak},
        "timers": snap["histograms"],
        "trace": trace_summary,
        "windows": len(lat),
        "work": work,
        "scorer": cell.scorer.name,
        "power_w": power_limit_w() if device == "cuda" else None,
    }
    out_metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = m.read(ctx)
        if v is None:
            log(f"[metric] {m.name}: nothing to read")
            continue
        entry = dict(v) if isinstance(v, dict) else {"value": v}
        entry["value"] = float(entry["value"])
        entry["unit"] = m.unit
        out_metrics[m.name] = entry
    result = {
        "correct": check.passed(checks),
        "attempted": int(queries),
        "failed": int(numbers["bad_rows"]),
        "metrics": out_metrics,
        "device": {"count": cell.chips, "memory_peak_bytes": int(peak)},
        "windows": len(lat),
        "checked_rows": numbers["rows"],
    }
    if trace_summary is not None:
        result["device"]["busy_s"] = trace_summary["busy_s"]
        result["device"]["window_s"] = trace_summary["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in trace_summary["device_ops"]],
            "idle_gaps": [[n, s] for n, s in trace_summary["idle_gaps"]],
        }
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.resolve(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"no result: the cell needs {cell.chips} CUDA device(s), {n} visible")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        log(f"no result: loaded once the window closed: {found}")
        return 3
    result["device"] = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        **result["device"],
    }
    # The line ends with the numbers compared, and so does standard error.
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
