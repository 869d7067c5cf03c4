"""Summarize the device-op durations of the most recent JAX trace.

Usage: python scripts/summarize_trace.py TRACE_DIR [TOP_N]
(TRACE_DIR is the directory given to jax.profiler.trace.)
"""

import collections
import glob
import gzip
import json
import sys

root = sys.argv[1]
paths = sorted(glob.glob(f"{root}/plugins/profile/*/*.trace.json.gz"))
with gzip.open(paths[-1]) as f:
    tr = json.load(f)
ev = tr["traceEvents"]
names = {}
for e in ev:
    if e.get("ph") == "M" and e.get("name") == "process_name":
        names[e["pid"]] = e["args"].get("name")
dur = collections.Counter()
cnt = collections.Counter()
for e in ev:
    if e.get("ph") == "X" and "dur" in e:
        pn = str(names.get(e.get("pid"), ""))
        # the GPU device planes ("/device:GPU:0 ..."), not host threads
        if "/device:GPU" in pn:
            dur[e["name"]] += e["dur"]
            cnt[e["name"]] += 1
tot = sum(dur.values())
print(f"total device op time: {tot/1e3:.1f} ms over {sum(cnt.values())} "
      f"events ({paths[-1]})")
for n, d in dur.most_common(int(sys.argv[2]) if len(sys.argv) > 2 else 30):
    print(f"{d/1e3:9.2f} ms  x{cnt[n]:<6} {n[:110]}")
