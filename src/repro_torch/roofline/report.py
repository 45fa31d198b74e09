"""Render the dry-run records into the roofline tables.

The reference's ``roofline/report.py`` on the port's records
(``launch/dryrun.py``): the same tables, whose time column is the
trace's (``t_trace_s``) where a record has one, then a table of what
only the port's records hold (where the fake tensors lived, whether the
rank fits the card, what the reference's specs would place, the bytes
sent, the kernel calls), the collectives by mesh axis and the decode
state's bytes where the records hold them, and one of both meshes side
by side.

  PYTHONPATH=src python -m repro_torch.roofline.report artifacts/dryrun_torch
"""
from __future__ import annotations

import json
import os
import sys


def fmt_s(x):
    return f"{x:.3e}" if x else "0"


def load(art_dir: str):
    recs = []
    for name in sorted(os.listdir(art_dir)):
        if name.endswith(".json"):
            with open(os.path.join(art_dir, name)) as f:
                recs.append(json.load(f))
    return recs


def _traced(recs) -> bool:
    """Whether the records are the port's (traced, not compiled)."""
    return any("t_trace_s" in r for r in recs)


def dryrun_table(recs, mesh: str):
    head = "trace(s)" if _traced(recs) else "compile(s)"
    rows = [f"| arch | shape | kind | {head} | GiB/dev | mb | "
            "coll GB/dev | collective mix |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh or r.get("skipped") or r.get("error"):
            continue
        coll = r.get("collective", {})
        mix = coll.get("by_op", {})
        top = sorted(mix.items(), key=lambda kv: -kv[1])[:2]
        mixs = " ".join(f"{k}:{v / 1e9:.2f}G" for k, v in top if v)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {r.get('t_trace_s', r.get('t_compile_s', '?'))} "
            f"| {r.get('memory', {}).get('per_device_total_gib', '?')} "
            f"| {r.get('microbatches', '-')} "
            f"| {coll.get('total', 0) / 1e9:.3f} | {mixs} |")
    skipped = [r for r in recs if r.get("mesh") == mesh and r.get("skipped")]
    for r in skipped:
        rows.append(f"| {r['arch']} | {r['shape']} | — | skipped "
                    "(structural) | | | | |")
    return "\n".join(rows)


def roofline_table(recs, mesh: str):
    rows = ["| arch | shape | compute(s) | memory(s) | collective(s) | "
            "dominant | useful-FLOP ratio | roofline |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh or r.get("skipped") or r.get("error"):
            continue
        t = r.get("roofline", {})
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(t.get('compute_s', 0))} "
            f"| {fmt_s(t.get('memory_s', 0))} "
            f"| {fmt_s(t.get('collective_s', 0))} "
            f"| {t.get('dominant', '?').replace('_s', '')} "
            f"| {t.get('useful_flops_ratio', 0):.3f} "
            f"| {t.get('roofline_frac', 0):.2%} |")
    return "\n".join(rows)


def port_table(recs, mesh: str):
    """The port's own columns of each traced cell."""
    rows = ["| arch | shape | device | fits | specs GiB | sent GB | "
            "kernels |",
            "|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh or r.get("skipped") or r.get("error"):
            continue
        mem = r.get("memory", {})
        kern = " ".join(f"{k}:{v}" for k, v in
                        sorted(r.get("kernels", {}).items()))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r.get('device', '?')} "
            f"| {mem.get('fits', '?')} | {mem.get('specs_argument_gib', '?')} "
            f"| {r.get('sent_bytes', 0) / 1e9:.3f} | {kern or '-'} |")
    return "\n".join(rows)


def axis_table(recs, mesh: str):
    """Each traced cell's collective operands (GB) by mesh axis and
    kind, and the bytes this rank sends over each axis (records of the
    products split over model ranks; older records have neither)."""
    rows = ["| arch | shape | axis | operands GB by kind | sent GB |",
            "|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh or r.get("skipped") or r.get("error"):
            continue
        by_axis = r.get("collective", {}).get("by_axis", {})
        sent = r.get("sent_by_axis", {})
        for axis in sorted(set(by_axis) | set(sent)):
            kinds = " ".join(f"{k}:{v / 1e9:.3f}" for k, v in
                             sorted(by_axis.get(axis, {}).items()) if v)
            rows.append(f"| {r['arch']} | {r['shape']} | {axis} "
                        f"| {kinds or '-'} "
                        f"| {sent.get(axis, 0) / 1e9:.3f} |")
    return "\n".join(rows)


def cache_table(recs, mesh: str):
    """Each decode cell's GiB a rank beside what the reference's specs
    place, and its decode state's GiB beside what
    ``decode_state_specs`` places (records of the caches laid out over
    the model ranks; older records have neither cache column)."""
    rows = ["| arch | shape | GiB/dev | specs GiB | cache GiB | "
            "specs cache GiB |", "|---|---|---|---|---|---|"]
    for r in recs:
        mem = r.get("memory", {})
        if r.get("mesh") != mesh or "cache_gib" not in mem:
            continue
        rows.append(f"| {r['arch']} | {r['shape']} "
                    f"| {mem['per_device_total_gib']} "
                    f"| {mem['specs_argument_gib']} | {mem['cache_gib']} "
                    f"| {mem['specs_cache_gib']} |")
    return "\n".join(rows)


def brief_table(recs):
    """One row a cell, each column single pod / multi-pod: the rank's
    GiB, whether it fits, its collective GB, the dominant term and the
    bound."""
    cells = {}
    for r in recs:
        if not r.get("skipped") and not r.get("error"):
            cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    columns = (
        lambda r: str(r["memory"]["per_device_total_gib"]),
        lambda r: str(r["memory"]["fits"]),
        lambda r: f"{r['collective']['total'] / 1e9:.3f}",
        lambda r: r["roofline"]["dominant"].replace("_s", ""),
        lambda r: fmt_s(r["roofline"]["bound_s"]))
    rows = ["| arch | shape | GiB/dev | fits | coll GB/dev | dominant | "
            "bound (s) |", "|---|---|---|---|---|---|---|"]
    for (arch, shape), by_mesh in sorted(cells.items()):
        vals = [" / ".join(col(by_mesh[m]) if m in by_mesh else "-"
                           for m in ("16x16", "2x16x16")) for col in columns]
        rows.append(f"| {arch} | {shape} | " + " | ".join(vals) + " |")
    return "\n".join(rows)


def summary(recs):
    ok = [r for r in recs if not r.get("skipped") and not r.get("error")]
    sk = [r for r in recs if r.get("skipped")]
    er = [r for r in recs if r.get("error")]
    doms = {}
    for r in ok:
        d = r.get("roofline", {}).get("dominant", "?")
        doms[d] = doms.get(d, 0) + 1
    done = "traced" if _traced(recs) else "compiled"
    return (f"{len(ok)} {done}, {len(sk)} skipped (structural), "
            f"{len(er)} failed; dominant terms: {doms}")


def main():
    art_dir = sys.argv[1] if len(sys.argv) > 1 else "artifacts/dryrun_torch"
    recs = load(art_dir)
    print("## Summary\n")
    print(summary(recs))
    for mesh in ("16x16", "2x16x16"):
        print(f"\n## Dry-run — mesh {mesh}\n")
        print(dryrun_table(recs, mesh))
        print(f"\n## Roofline — mesh {mesh}\n")
        print(roofline_table(recs, mesh))
        if _traced(recs):
            print(f"\n## The port — mesh {mesh}\n")
            print(port_table(recs, mesh))
            if any("by_axis" in r.get("collective", {}) for r in recs):
                print(f"\n## Collectives by axis — mesh {mesh}\n")
                print(axis_table(recs, mesh))
            if any("cache_gib" in r.get("memory", {}) for r in recs):
                print(f"\n## Decode state — mesh {mesh}\n")
                print(cache_table(recs, mesh))
    if _traced(recs):
        print("\n## Both meshes (16x16 / 2x16x16)\n")
        print(brief_table(recs))


if __name__ == "__main__":
    main()
