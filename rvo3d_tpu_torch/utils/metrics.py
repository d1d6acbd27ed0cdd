"""Structured metrics logging: a JSONL writer and the per-drone reward-curve
CSV and PNG (counterpart of rvo3d_tpu/utils/metrics.py; the reference
prints epochs and writes its curves after the run, train_process.py).
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Dict, Iterable, Optional


class JSONLLogger:
    def __init__(self, path: str, echo: bool = True):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.echo = echo
        self._t0 = time.time()

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("wall_time_s", round(time.time() - self._t0, 3))
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.echo:
            short = {k: v for k, v in record.items()
                     if not isinstance(v, (list, dict))}
            print(short)

    def read(self) -> Iterable[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


def write_reward_csv(path: str, epochs: Iterable[Dict[str, Any]],
                     key: str = "ep_ret_mean") -> None:
    """Per-drone reward curve CSV (reference: train_process.py:131-141)."""
    rows = [e for e in epochs if key in e]
    if not rows:
        return
    n = len(rows[0][key])
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["epoch"] + [f"drone_{i}" for i in range(n)])
        for e in rows:
            w.writerow([e.get("epoch", "")] + list(e[key]))


def plot_reward_curves(jsonl_path: str, out_png: str,
                       key: str = "ep_ret_mean") -> Optional[str]:
    """Reward-curve PNG per drone (reference: train_process.py:143-171).
    Matplotlib is imported lazily and failures are non-fatal."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    logger = JSONLLogger(jsonl_path, echo=False)
    rows = [e for e in logger.read() if key in e]
    if not rows:
        return None
    n = len(rows[0][key])
    xs = [e.get("epoch", i) for i, e in enumerate(rows)]
    fig, ax = plt.subplots(figsize=(8, 5))
    for i in range(n):
        ax.plot(xs, [e[key][i] for e in rows], label=f"drone {i}")
    ax.set_xlabel("epoch")
    ax.set_ylabel("mean episode return")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png
