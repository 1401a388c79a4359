"""Corpus statistics: token-length histograms over training JSONL (a copy
of rwkvtts_tpu/data/corpus_stats.py; the reference's corpus_statistics.py,
whose histograms pick the max_tokens_k / pad_to budgets).

    python -m rwkvtts_torch.data.corpus_stats 'data/*.jsonl' --field semantic_tokens
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence

import numpy as np


def row_lengths(rows: Sequence[dict], field: str, text_cost: float = 0.5) -> np.ndarray:
    out: List[int] = []
    for r in rows:
        n = 0
        v = r.get(field)
        if isinstance(v, list):
            n += len(v) if not (v and isinstance(v[0], list)) else len(v[0])
        n += int(len(str(r.get("text", ""))) * text_cost)
        out.append(n)
    return np.asarray(out)


def summarize(lengths: np.ndarray, buckets: Sequence[int] = (128, 256, 512, 1024, 2048, 4096)) -> Dict:
    if len(lengths) == 0:
        return {"count": 0}
    qs = np.percentile(lengths, [50, 90, 95, 99])
    hist = {f"<={b}": int((lengths <= b).sum()) for b in buckets}
    return {
        "count": int(len(lengths)),
        "mean": float(lengths.mean()),
        "p50": float(qs[0]),
        "p90": float(qs[1]),
        "p95": float(qs[2]),
        "p99": float(qs[3]),
        "max": int(lengths.max()),
        "cumulative_histogram": hist,
        "total_tokens": int(lengths.sum()),
    }


def main(argv=None):
    from rwkvtts_torch.data.jsonl_dataset import load_jsonl_rows

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("patterns", nargs="+")
    ap.add_argument("--field", default="semantic_tokens")
    ap.add_argument("--max-rows", type=int, default=None)
    args = ap.parse_args(argv)
    rows = load_jsonl_rows(args.patterns, max_rows=args.max_rows)
    print(json.dumps(summarize(row_lengths(rows, args.field)), indent=2))


if __name__ == "__main__":
    main()
