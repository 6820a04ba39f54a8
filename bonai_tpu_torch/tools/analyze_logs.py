"""Analyse the train CLI's ``train_log.jsonl`` (counterpart of
``tools/analyze_logs.py``).

    python -m bonai_tpu_torch.tools.analyze_logs cal_train_time LOG [LOG ...]
    python -m bonai_tpu_torch.tools.analyze_logs plot_curve LOG [LOG ...] \\
        [--keys loss ...] [--out curve.png]

``cal_train_time`` prints each log's mean, fastest and slowest seconds an
iteration, over the rows that carry ``time``.  ``plot_curve`` draws the
keys over ``iter`` and needs matplotlib (the machine with the card has
none).
"""

from __future__ import annotations

import argparse
import json


def load(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def cal_train_time(paths):
    """The lines ``cal_train_time`` prints, one a log."""
    lines = []
    for path in paths:
        recs = [r for r in load(path) if "time" in r]
        if not recs:
            lines.append(f"{path}: no records")
            continue
        times = [r["time"] for r in recs]
        lines.append(f"{path}: avg {sum(times)/len(times):.4f}s/iter "
                     f"(n={len(times)}, fastest {min(times):.4f}, "
                     f"slowest {max(times):.4f})")
    return lines


def plot_curve(paths, keys=("loss",), out="curve.png"):
    """Draw ``keys`` over ``iter`` for every log into ``out``."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("plot_curve needs matplotlib, which is not "
                           "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure()
    for path in paths:
        recs = load(path)
        for key in keys:
            xs = [r["iter"] for r in recs if key in r]
            ys = [r[key] for r in recs if key in r]
            plt.plot(xs, ys, label=f"{path}:{key}")
    plt.xlabel("iter")
    plt.legend()
    fig.savefig(out)
    plt.close(fig)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="task", required=True)
    p1 = sub.add_parser("plot_curve")
    p1.add_argument("json_logs", nargs="+")
    p1.add_argument("--keys", nargs="+", default=["loss"])
    p1.add_argument("--out", default="curve.png")
    p2 = sub.add_parser("cal_train_time")
    p2.add_argument("json_logs", nargs="+")
    args = parser.parse_args(argv)
    if args.task == "cal_train_time":
        for line in cal_train_time(args.json_logs):
            print(line)
    else:
        print(f"wrote {plot_curve(args.json_logs, args.keys, args.out)}")


if __name__ == "__main__":
    main()
