"""Continuous OCR serving — ``python -m effocr_torch serve``: stdin paths
or a watched directory -> JSONL.  The port of the JAX package's
cli/serve.py, on the torch engine (``--device``, default cuda).

Requests accumulate into line batches (continuous batching: a batch runs
when line_batch requests are waiting OR the oldest request has waited
--max_latency_ms) and ride the same engine as ``infer``, over every
visible card with --data_parallel (one engine replica a card).  Each
engine batch logs its size to stderr ("serve: batch of N").

Modes:
  --stdin       read one image path per line from stdin; emit one JSON
                object per line to stdout ({"path", "text"}), in input
                order.  EOF drains and exits.
  --watch_dir   poll a directory for new image files; append results to
                --out JSONL; processed files are remembered (and skipped)
                for the life of the process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Iterable, Iterator, Optional, Tuple

from effocr_torch.cli.infer import add_engine_args, load_engine
from effocr_torch.kernels import cuda_nms, cuda_top1


def serve_loop(
    engine,
    requests: Iterable[Tuple[str, "object"]],
    emit: Callable[[str, str], None],
    batch_size: int,
    max_latency_s: float = 0.05,
    now: Callable[[], float] = time.monotonic,
    stats_out=sys.stderr,
) -> int:
    """Continuous-batching core, separated from I/O for testability.

    requests: iterable of (key, image) — image is a path or HWC uint8
    array; a None item is a poll tick (flush-latency check against the
    oldest queued request).  emit(key, text) is called per result in
    request order.  Returns the number of lines served.
    """
    queue: list = []
    oldest: Optional[float] = None
    served = 0
    t0 = now()

    def run_batch(batch):
        keys = [k for k, _ in batch]
        imgs = [im for _, im in batch]
        results = engine.run(imgs)
        # engine.run keys string inputs by path, arrays by position
        for i, k in enumerate(keys):
            r = results[imgs[i]] if isinstance(imgs[i], str) else results[i]
            emit(k, r)

    def flush():
        nonlocal served, oldest
        if not queue:
            return
        try:
            run_batch(queue)
        except Exception:
            # one bad item (unreadable path, truncated upload) must not
            # take down the server or the rest of the batch — isolate by
            # re-running per item
            for item in queue:
                try:
                    run_batch([item])
                except Exception as e:
                    print(f"serve: failed {item[0]!r}: {e}",
                          file=stats_out or sys.stderr)
                    emit(item[0], "")
        served += len(queue)
        queue.clear()
        oldest = None

    for item in requests:
        if item is not None:
            queue.append(item)
            if oldest is None:
                oldest = now()
        if len(queue) >= batch_size:
            flush()
        elif queue and oldest is not None and now() - oldest >= max_latency_s:
            flush()
    flush()
    dt = max(now() - t0, 1e-9)
    if stats_out is not None:
        print(f"served {served} lines in {dt:.2f}s "
              f"({served / dt:.1f} lines/s)", file=stats_out)
    return served


def _stdin_requests(tick_s: float = 0.05) -> Iterator:
    """Read paths from stdin without blocking the latency flush: while
    stdin is idle, None poll ticks keep serve_loop's max-latency check
    running (an RPC-style client that sends one path and waits for its
    response must not deadlock against a partial batch)."""
    import select

    buf = ""
    while True:
        ready, _, _ = select.select([sys.stdin], [], [], tick_s)
        if not ready:
            yield None
            continue
        chunk = os.read(sys.stdin.fileno(), 65536).decode()
        if not chunk:            # EOF
            if buf.strip():
                yield (buf.strip(), buf.strip())
            return
        buf += chunk
        while "\n" in buf:
            line, buf = buf.split("\n", 1)
            path = line.strip()
            if path:
                yield (path, path)


def _watch_requests(watch_dir: str, poll_s: float,
                    stop_after_s: float = 0.0,
                    processed_dir: Optional[str] = None) -> Iterator:
    """Yield new image files once their size is stable across two polls
    (files still being copied in are skipped until complete); None ticks
    drive latency flushes while idle.

    processed_dir: when set, main()'s emit moves finished files there —
    that also bounds the per-poll scan and the seen set for long-running
    servers (entries for vanished files are pruned)."""
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}
    seen = set()
    pending_size: dict = {}
    t0 = time.monotonic()
    while True:
        found = False
        present = set()
        with os.scandir(watch_dir) as it:
            entries = sorted(it, key=lambda e: e.name)
        for e in entries:
            if os.path.splitext(e.name)[1].lower() not in exts:
                continue
            path = e.path
            present.add(path)
            if path in seen:
                continue
            try:
                size = e.stat().st_size
            except OSError:
                continue
            if pending_size.get(path) == size:
                pending_size.pop(path, None)
                seen.add(path)
                found = True
                yield (path, path)
            else:
                pending_size[path] = size     # wait one poll for stability
        seen &= present                        # moved/deleted files forget
        if not found:
            yield None
            time.sleep(poll_s)
        if stop_after_s and time.monotonic() - t0 >= stop_after_s:
            return


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m effocr_torch serve",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_engine_args(p)   # engine knobs shared with `infer`, never drift
    p.add_argument("--stdin", action="store_true", default=False)
    p.add_argument("--watch_dir", type=str, default=None)
    p.add_argument("--processed_dir", type=str, default=None,
                   help="watch mode: move finished files here (keeps the "
                        "watch dir and the dedup set bounded on "
                        "long-running servers)")
    p.add_argument("--out", type=str, default=None,
                   help="JSONL output path (watch mode; default stdout)")
    p.add_argument("--max_latency_ms", type=float, default=200.0,
                   help="flush a partial batch when the oldest request "
                        "has waited this long")
    p.add_argument("--poll_ms", type=float, default=100.0)
    p.add_argument("--stop_after_s", type=float, default=0.0,
                   help="watch mode: exit after this many seconds "
                        "(0 = run forever)")
    args = p.parse_args(argv)

    if not (args.stdin or args.watch_dir):
        p.error("pick a source: --stdin or --watch_dir")

    engine = load_engine(args)
    run = engine.run

    def run_logged(imgs):
        # one stderr line per engine batch: the boundaries serve_loop chose
        print(f"serve: batch of {len(imgs)}", file=sys.stderr)
        return run(imgs)

    engine.run = run_logged

    if args.out:
        sink_f = open(args.out, "a", buffering=1)
    else:
        sink_f = sys.stdout

    if args.processed_dir:
        os.makedirs(args.processed_dir, exist_ok=True)

    def emit(key, text):
        sink_f.write(json.dumps({"path": key, "text": text},
                                ensure_ascii=False) + "\n")
        sink_f.flush()
        if args.processed_dir and isinstance(key, str) and os.path.exists(key):
            os.replace(key, os.path.join(args.processed_dir,
                                         os.path.basename(key)))

    requests = (_stdin_requests() if args.stdin
                else _watch_requests(args.watch_dir, args.poll_ms / 1e3,
                                     args.stop_after_s,
                                     processed_dir=args.processed_dir))
    serve_loop(engine, requests, emit, args.line_batch,
               max_latency_s=args.max_latency_ms / 1e3)
    # which hand-written kernels the served batches launched (0 on CPU)
    print(f"serve: kernel launches: nms {cuda_nms.nms_kernel.launches}, "
          f"top1 {cuda_top1.top1_kernel.launches}", file=sys.stderr)
    if args.out:
        sink_f.close()


if __name__ == "__main__":
    main()
