"""CLI: data-preparation one-offs (scripts/add_sp_label.sh + mhop_utils.py).

The port of the JAX package's ``cli/prep.py`` (host only; the same files
out).

Subcommands:

  add-sp-label ORIGINAL RETRIEVED OUT
      Attach sentence-level SP supervision to retrieved chains for reader
      training — the scripts/add_sp_label.sh workflow (which shells into
      mhop_utils.py; that script's save step is broken upstream — the
      ${SASAVED_PATH} typo — so the output path never worked there).
      ORIGINAL is raw HotpotQA json (with context + supporting_facts),
      RETRIEVED is the candidate-chain dump from cli/eval_mhop_retrieval
      (--save-path), OUT gets one JSON row per question.

  hotpot-to-mhop RAW OUT
      Raw HotpotQA json → multi-hop training/eval rows (hotpot_sp_data,
      mhop_utils.py:55-104).

  index-id-map ID2DOC OUT
      Row index → doc id JSON map (utils/gen_index_id_map.py:6-14).
"""

import argparse
import json

from ..data import prep
from .common import load_json_flex as _load


def _dump_jsonl(rows, path):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("add-sp-label")
    sp.add_argument("original", help="raw HotpotQA json (context + sp facts)")
    sp.add_argument("retrieved", help="chain dump from eval_mhop_retrieval")
    sp.add_argument("out")

    hm = sub.add_parser("hotpot-to-mhop")
    hm.add_argument("raw")
    hm.add_argument("out")
    hm.add_argument("--linked-abstracts", default="",
                    help="wiki abstracts with hyperlink targets, json "
                        '{title: [linked titles]} or jsonl rows with '
                        '"title" + "linked"/"hyperlinks" — enables '
                        "pick_bridge's link-direction fallback when the "
                        "answer string does not disambiguate the hop order "
                        "(without it, ambiguous bridges default to the "
                        "second supporting-facts title)")

    im = sub.add_parser("index-id-map")
    im.add_argument("id2doc")
    im.add_argument("out")

    args = p.parse_args(argv)
    if args.cmd == "add-sp-label":
        raw = _load(args.original)
        retrieved = _load(args.retrieved)
        # sentence lists come from the raw data's context field
        title2sents = {}
        for item in raw:
            for title, sents in item.get("context", []):
                title2sents[title] = sents
        # align by question (the retrieved dump preserves input order, but
        # be safe against filtered rows); fail loud on ambiguity — a
        # duplicate question text would silently attach the wrong gold
        by_q = {}
        for r in raw:
            if r["question"] in by_q:
                raise ValueError(
                    f"duplicate question in ORIGINAL: {r['question']!r} — "
                    "question-keyed alignment would mispair gold labels; "
                    "dedupe the raw file first")
            by_q[r["question"]] = r
        missing = [r["question"] for r in retrieved
                   if r["question"] not in by_q]
        if missing:
            raise ValueError(
                f"{len(missing)} retrieved questions absent from ORIGINAL "
                f"(first: {missing[0]!r}) — was the dump produced from a "
                "different split?")
        raw_aligned = [by_q[r["question"]] for r in retrieved]
        out = prep.add_sp_labels(raw_aligned, retrieved, title2sents)
        _dump_jsonl(out, args.out)
        print(f"wrote {len(out)} rows to {args.out}")
    elif args.cmd == "hotpot-to-mhop":
        title2linked = None
        if args.linked_abstracts:
            with open(args.linked_abstracts) as f:
                txt = f.read()
            try:                                 # one {title: [...]} map
                blob = json.loads(txt)
            except json.JSONDecodeError:         # jsonl abstract rows
                blob = [json.loads(l) for l in txt.splitlines()
                        if l.strip()]
            if isinstance(blob, dict):
                title2linked = blob
            else:
                title2linked = {
                    r["title"]: list(r.get("linked",
                                           r.get("hyperlinks", [])))
                    for r in blob}
        rows = prep.hotpot_to_mhop_rows(_load(args.raw),
                                        title2linked=title2linked)
        _dump_jsonl(rows, args.out)
        print(f"wrote {len(rows)} rows to {args.out}")
    elif args.cmd == "index-id-map":
        prep.gen_index_id_map(args.id2doc, args.out)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
