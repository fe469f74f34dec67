#!/usr/bin/env python3
"""Simulate how pytest-xdist's `--dist load` schedules Tier-1 over its
workers, from measured per-test times, and print the predicted wall.

    python -m pytest tests/ ... --junitxml=times.xml       # any full run
    python3 tier1_schedule.py times.xml [--workers 6] [--extra 0,10,20]
        [--drop tests/test_torch_io.py,tests/test_torch_cli.py]
        [--limit 1470 --scale 0.9,1.0,1.2]

The collection order is taken from `pytest --collect-only` on this tree
(the Tier-1 command's `-m 'not slow'`); a test without a time in the junit
file counts 0.05 s.  `--extra` lists counts of 0.05 s items to insert
before tests/test_torch_md.py, and `--drop` node-id prefixes to leave
out, to see how the wall moves with the number of collected items.
With `--limit`, each line also gives the passes finished by that many
seconds (the Tier-1 command's timeout; a cut run counts as far as it got)
with every time multiplied by each `--scale` (a slower or faster
machine): a test passes if it passed in the junit file, an extra item
always.

The model is xdist 3.8's LoadScheduling: the first N // workers // 4
items go to each worker in consecutive chunks; when a worker's queue
falls below pending // workers // 4 it is refilled to pending // workers
// 2 items (unless its last test took >= 0.1 s and two are still
queued); a worker never takes items from another's queue.  Worker start
and collection time are left out.
"""
import argparse
import heapq
import subprocess
import sys
import xml.etree.ElementTree as ET


def junit_times(path):
    """({node: seconds}, {node: passed})."""
    out, ok = {}, {}
    for tc in ET.parse(path).getroot().iter("testcase"):
        node = tc.get("classname").replace(".", "/") + ".py::" + tc.get("name")
        out[node] = float(tc.get("time") or 0.0)
        ok[node] = not any(ch.tag in ("failure", "error", "skipped")
                           for ch in tc)
    return out, ok


def collection():
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-q", "-m", "not slow",
         "--collect-only", "-p", "no:cacheprovider", "-p", "no:randomly"],
        capture_output=True, text=True, check=False)
    return [ln.strip() for ln in r.stdout.splitlines() if "::" in ln]


def simulate(order, seconds, workers=6):
    """(wall, per-worker finish times, {item index: its end time}) of
    `order` under --dist load."""
    pending = list(range(len(order)))
    queue = [[] for _ in range(workers)]

    def send(w, k):
        k = min(k, len(pending))
        queue[w].extend(pending[:k])
        del pending[:k]

    chunk = max(len(order) // workers // 4, 2)
    for w in range(workers):
        send(w, chunk)
    events = [(seconds(order[queue[w][0]]), w) for w in range(workers)
              if queue[w]]
    heapq.heapify(events)
    finish = [0.0] * workers
    ends = {}
    while events:
        t, w = heapq.heappop(events)
        done = queue[w].pop(0)
        ends[done] = t
        if pending:
            lo = max(2, len(pending) // workers // 4)
            hi = max(2, len(pending) // workers // 2)
            long_test = seconds(order[done]) >= 0.1
            if len(queue[w]) < lo and not (long_test and len(queue[w]) >= 2):
                send(w, max(hi - len(queue[w]), 2 - len(queue[w])))
        if queue[w]:
            heapq.heappush(events, (t + seconds(order[queue[w][0]]), w))
        else:
            finish[w] = t
    return max(finish), finish, ends


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--extra", default="0")
    ap.add_argument("--drop", default="")
    ap.add_argument("--limit", type=float, default=None)
    ap.add_argument("--scale", default="1.0")
    args = ap.parse_args()
    times, passed = junit_times(args.junit)
    drop = tuple(p for p in args.drop.split(",") if p)
    order = [n for n in collection() if not (drop and n.startswith(drop))]

    def seconds(node):
        return times.get(node, 0.05)
    at = next((i for i, n in enumerate(order)
               if n.startswith("tests/test_torch_md.py")), len(order))
    for k in (int(v) for v in args.extra.split(",")):
        o = order[:at] + [f"extra{i}" for i in range(k)] + order[at:]
        wall, finish, _ = simulate(o, seconds, args.workers)
        line = (f"{len(o)} items (+{k}): wall {wall:.0f} s, workers "
                f"{[round(f) for f in finish]}")
        if args.limit is not None:
            counts = []
            for sc in (float(v) for v in args.scale.split(",")):
                _, _, ends = simulate(o, lambda n, sc=sc: sc * seconds(n),
                                      args.workers)
                counts.append(sum(1 for i, n in enumerate(o)
                                  if ends[i] <= args.limit
                                  and passed.get(n, True)))
            line += f"; passes by {args.limit:.0f} s at scales " \
                    f"{args.scale}: {counts}"
        print(line)


if __name__ == "__main__":
    main()
