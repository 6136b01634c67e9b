"""Load benchmark for the synthesis server (``python -m eegsynth_torch.serve``):
the CLI of ``scripts/bench_serve.py``.

N concurrent closed-loop clients drive a running server for a fixed time;
the result is sustained throughput (requests/s, windows/s) and latency
percentiles (p50, p95, p99), over a mix of TimeGAN and CGAN requests, with
a hung client (a half-open request that never sends its body) held open
for the whole run: a server that serialised its sockets would stall behind
it. The server serialises device work behind one lock, so this measures
what concurrent clients see end to end: queueing, the device, npz packing
and the socket.

    python -m eegsynth_torch.serve --runs_dir ... --port 8777 --device cuda &
    python -m eegsynth_torch.tools.bench_serve --port 8777 --clients 4 \\
        --seconds 30 --timegan-runs posture1_no_exo,posture2_no_exo \\
        [--cgan-models no_exo] [--no-hung-client] [--json-out out.json]
"""

from __future__ import annotations

import argparse
import json
import socket
import threading
import time
from http.client import HTTPConnection, HTTPException

import numpy as np


def run_load(host, port, plans, clients, seconds, hold_hung=True) -> dict:
    """``plans``: (path, body, windows) request templates, cycled by each
    client with a seed of its own per request. Returns the counts, the
    latency percentiles (ms) and the windows served a second."""
    stop = time.monotonic() + seconds
    lat, windows, errors = [], [], [0]
    lock = threading.Lock()

    hung = None
    if hold_hung:
        hung = socket.create_connection((host, port), timeout=seconds + 60)
        hung.sendall(b"POST /synthesize HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Length: 999\r\n\r\n")

    def client(i):
        k = i
        while time.monotonic() < stop:
            path, body, nwin = plans[k % len(plans)]
            k += clients
            body = dict(body, seed=k)
            t0 = time.monotonic()
            try:
                c = HTTPConnection(host, port, timeout=120)
                c.request("POST", path, body=json.dumps(body))
                r = c.getresponse()
                data = r.read()
                c.close()
                ok = r.status == 200 and len(data) > 0
            except (OSError, HTTPException, ValueError):
                # a broken or truncated response is an error, not the end
                # of the client thread (which would skew req/s silently)
                ok = False
            dt = time.monotonic() - t0
            with lock:
                if ok:
                    lat.append(dt)
                    windows.append(nwin)
                else:
                    errors[0] += 1

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if hung is not None:
        hung.close()
    lat_a = np.asarray(lat)

    def pct(q):
        return round(float(np.percentile(lat_a, q)) * 1e3, 1) if len(lat) else None

    return {
        "clients": clients,
        "wall_s": round(wall, 2),
        "requests": len(lat),
        "errors": errors[0],
        "req_per_s": round(len(lat) / wall, 2),
        "windows_per_s": round(float(np.sum(windows)) / wall, 1),
        "p50_ms": pct(50),
        "p95_ms": pct(95),
        "p99_ms": pct(99),
        "max_ms": round(float(lat_a.max()) * 1e3, 1) if len(lat) else None,
    }


def plans_from(timegan_runs: str, cgan_models: str, n: int, seq_len: int) -> list:
    """The request templates of the CLI's run and model lists."""
    plans = [("/synthesize", {"run": run, "n": n, "seq_len": seq_len}, n)
             for run in filter(None, timegan_runs.split(","))]
    plans += [("/synthesize_cgan", {"model": tag, "label": 0, "n": n}, n)
              for tag in filter(None, cgan_models.split(","))]
    return plans


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--n", type=int, default=64, help="windows per request")
    ap.add_argument("--seq-len", type=int, default=768)
    ap.add_argument("--timegan-runs", type=str, default="",
                    help="comma-separated run names to cycle through")
    ap.add_argument("--cgan-models", type=str, default="",
                    help="comma-separated CGAN tags to mix in")
    ap.add_argument("--no-hung-client", action="store_true",
                    help="skip holding a dead half-open request during the run")
    ap.add_argument("--json-out", type=str, default="")
    args = ap.parse_args(argv)

    plans = plans_from(args.timegan_runs, args.cgan_models, args.n, args.seq_len)
    if not plans:
        raise SystemExit("give at least one of --timegan-runs / --cgan-models")
    # every plan once before the timed window (the kernels' first launches)
    for path, body, _ in plans:
        c = HTTPConnection(args.host, args.port, timeout=600)
        c.request("POST", path, body=json.dumps(dict(body, seed=0)))
        r = c.getresponse()
        r.read()
        c.close()
        print(f"[bench_serve] warmed {path} {body.get('run') or body.get('model')}"
              f" -> {r.status}", flush=True)

    out = run_load(args.host, args.port, plans, args.clients, args.seconds,
                   hold_hung=not args.no_hung_client)
    print(json.dumps(out), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
