"""The kernel times of chip_smoke.py runs of two checkouts compared: each
``[time]`` line's kernel time, the mean over each checkout's runs, the
second's difference, and how many lie within +-6%.

    python3 probes/smoke_times.py A_1.txt A_2.txt ... -- B_1.txt B_2.txt ...

each file the output of one ``python3 chip_smoke.py`` run (checkout A's
runs before ``--``, B's after)."""
import re
import sys
from pathlib import Path


def times(path) -> dict:
    """{[time] line's label: kernel ms} of one run's output."""
    out = {}
    for line in Path(path).read_text().splitlines():
        if not line.startswith("[time]"):
            continue
        m = re.search(r"kernel ([0-9.]+) ms", line)
        if m:
            key = re.split(r": kernel", line[7:])[0].strip()
            out.setdefault(key, float(m.group(1)))
    return out


def main(runs_a, runs_b):
    a = [times(p) for p in runs_a]
    b = [times(p) for p in runs_b]
    rows = []
    for key in a[0]:
        if not all(key in t for t in a + b):
            continue
        ma = sum(t[key] for t in a) / len(a)
        mb = sum(t[key] for t in b) / len(b)
        rows.append((abs(mb / ma - 1), key, mb / ma - 1,
                     [t[key] for t in a], [t[key] for t in b]))
    rows.sort(reverse=True)
    print(f"{sum(r[0] <= 0.06 for r in rows)} of {len(rows)} within +-6%")
    for _, key, d, ta, tb in rows:
        print(f"{d:+.1%} {key}: A {ta} B {tb}")


if __name__ == "__main__":
    args = sys.argv[1:]
    cut = args.index("--")
    main(args[:cut], args[cut + 1:])
