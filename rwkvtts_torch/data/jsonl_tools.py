"""JSONL corpus maintenance (a copy of rwkvtts_tpu/data/jsonl_tools.py; the
reference's utils/filter_jsonl_fields.py, which keeps or drops fields, and
utils/align_voxbox_properties.py, which joins speaker-property metadata
onto token rows by key).

    python -m rwkvtts_torch.data.jsonl_tools filter in.jsonl out.jsonl --keep text semantic_tokens
    python -m rwkvtts_torch.data.jsonl_tools join tokens.jsonl props.jsonl out.jsonl --on utt_id
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Iterable, List, Optional, Sequence


def filter_fields(
    rows: Iterable[dict],
    keep: Optional[Sequence[str]] = None,
    drop: Sequence[str] = (),
) -> List[dict]:
    out = []
    for r in rows:
        if keep is not None:
            r = {k: v for k, v in r.items() if k in keep}
        if drop:
            r = {k: v for k, v in r.items() if k not in drop}
        out.append(r)
    return out


def join_on(
    rows: Iterable[dict],
    side: Iterable[dict],
    on: str,
    fields: Optional[Sequence[str]] = None,
) -> List[dict]:
    """Left-join `side` metadata onto `rows` by key column `on`."""
    index: Dict[str, dict] = {}
    for s in side:
        if on in s:
            index[str(s[on])] = s
    out = []
    for r in rows:
        merged = dict(r)
        m = index.get(str(r.get(on)))
        if m:
            for k, v in m.items():
                if k == on:
                    continue
                if fields is None or k in fields:
                    merged.setdefault(k, v)
        out.append(merged)
    return out


def _read(path):
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def _write(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    pf = sub.add_parser("filter")
    pf.add_argument("src")
    pf.add_argument("dst")
    pf.add_argument("--keep", nargs="*", default=None)
    pf.add_argument("--drop", nargs="*", default=[])
    pj = sub.add_parser("join")
    pj.add_argument("src")
    pj.add_argument("side")
    pj.add_argument("dst")
    pj.add_argument("--on", required=True)
    pj.add_argument("--fields", nargs="*", default=None)
    args = ap.parse_args(argv)
    if args.cmd == "filter":
        _write(args.dst, filter_fields(_read(args.src), args.keep, args.drop))
    else:
        _write(args.dst, join_on(_read(args.src), _read(args.side), args.on, args.fields))


if __name__ == "__main__":
    main()
