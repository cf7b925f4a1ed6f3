"""Render the port's dry-run records (``launch/dryrun.py``) into tables
(PyTorch port of the JAX package's ``launch/report.py``).

  PYTHONPATH=src python -m repro_torch.launch.report                 # roofline table
  PYTHONPATH=src python -m repro_torch.launch.report --compare results/dryrun_torch_iter0
  PYTHONPATH=src python -m repro_torch.launch.report --variants      # serve variants

The roofline terms are at one H100 SXM's published peaks
(``roofline.analysis``), each collective's bytes at the NVLink rate or,
where its group spans nodes, the network's.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import get_config
from repro_torch.launch.shapes import SHAPES
from repro_torch.roofline import analysis as ra


def load(results_dir):
    recs = {}
    for f in glob.glob(os.path.join(results_dir, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        recs[(r["cell"], r["mesh"], r.get("variant", "axllm-int8"))] = r
    return recs


def corrected_totals(rec):
    """Apply the 1/2-group delta extrapolation (per-device -> global); a
    copy of ``benchmarks/roofline_table.corrected_totals`` with the
    inter-node bytes beside the collective bytes."""
    aux = rec.get("aux")
    chips = rec["chips"]
    if not aux:
        return None
    ng = aux["n_groups"]
    out = {}
    for key, src in (("flops", "flops"), ("bytes", "bytes"),
                     ("coll", "collective_bytes"),
                     ("inter", "collective_inter_bytes")):
        c1, c2 = aux["g1"].get(src), aux["g2"].get(src)
        if c1 is None or c2 is None:
            return None
        out[key] = ra.extrapolate(c1, c2, ng)
    # train aux runs used a reduced batch; scale to the full global batch
    cell_shape = rec["cell"].split(":")[1]
    spec = SHAPES[cell_shape]
    if spec.kind == "train":
        scale = spec.global_batch / aux["g1"]["aux_batch"]
        for k in out:
            out[k] *= scale
    for k in ("flops", "bytes", "coll", "inter"):
        out[f"{k}_global"] = out[k] * chips
    return out


def corrected(rec):
    return corrected_totals(rec)


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def global_totals(rec):
    """(FLOPs, bytes, intra-node collective bytes, inter-node bytes) over
    every chip, and "*" where they are the raw per-rank count times the
    chips (no aux runs; the eager count is whole, unlike JAX's raw
    scan-body count)."""
    corr = corrected(rec)
    if corr:
        fl, by, co, inter = (corr["flops_global"], corr["bytes_global"],
                             corr["coll_global"], corr["inter_global"])
        tag = ""
    else:
        chips = rec["chips"]
        fl = (rec["cost_analysis"].get("flops") or 0) * chips
        by = (rec["cost_analysis"].get("bytes accessed") or 0) * chips
        co = rec["collective_bytes"] * chips
        inter = rec.get("collective_inter_bytes", 0.0) * chips
        tag = "*"
    return fl, by, co - inter, inter, tag


def roofline_rows(recs, mesh="gpu16x16", variant="axllm-int8"):
    rows = []
    for (cell, m, v), rec in sorted(recs.items()):
        if m != mesh or v != variant:
            continue
        arch, shape = cell.split(":")
        if rec["status"] == "skipped":
            rows.append((cell, "SKIP", rec["reason"][:48], "", "", "", "",
                         ""))
            continue
        if rec["status"] != "ok":
            rows.append((cell, "ERR", rec.get("error", "")[:48], "", "", "",
                         "", ""))
            continue
        cfg = get_config(arch)
        spec = SHAPES[shape]
        fl, by, co, inter, tag = global_totals(rec)
        t = ra.roofline_terms(fl, by, co, rec["chips"], inter_bytes=inter)
        mf = ra.model_flops(cfg, spec.kind, spec.seq, spec.global_batch)
        ratio = mf / fl if fl else float("nan")
        temp = rec["memory"].get("temp_size_in_bytes")
        rows.append((cell, t["dominant"] + tag,
                     f"{t['compute_s']:.2e}", f"{t['memory_s']:.2e}",
                     f"{t['collective_s']:.2e}", f"{ratio:.2f}",
                     fmt_bytes(temp), f"{rec.get('count_s', '-')}s"))
    return rows


def print_roofline(recs, mesh, variant):
    print(f"\n### Roofline — {mesh} / {variant} "
          f"(terms in s, H100 SXM peaks; * = one rank's count x chips)\n")
    print("| cell | dominant | compute | memory | collective | "
          "model/counted flops | temp/rank | count |")
    print("|---|---|---|---|---|---|---|---|")
    for r in roofline_rows(recs, mesh, variant):
        print("| " + " | ".join(str(x) for x in r) + " |")


def print_compare(recs_new, recs_old, mesh="gpu16x16", variant="axllm-int8"):
    print("\n### before/after (temp bytes + collective bytes per rank)\n")
    print("| cell | temp before | temp after | coll before | coll after |")
    print("|---|---|---|---|---|")
    for key in sorted(recs_new):
        cell, m, v = key
        if m != mesh or v != variant:
            continue
        a, b = recs_old.get(key), recs_new[key]
        if not a or a["status"] != "ok" or b["status"] != "ok":
            continue
        ta = a["memory"].get("temp_size_in_bytes")
        tb = b["memory"].get("temp_size_in_bytes")
        ca, cb = a.get("collective_bytes"), b.get("collective_bytes")
        print(f"| {cell} | {fmt_bytes(ta)} | {fmt_bytes(tb)} | "
              f"{fmt_bytes(ca)} | {fmt_bytes(cb)} |")


def print_variants(recs, cells, mesh="gpu16x16"):
    print("\n### serve-variant comparison (per rank)\n")
    print("| cell | variant | mem term (s) | coll term (s) | args bytes | "
          "temp |")
    print("|---|---|---|---|---|---|")
    for cell in cells:
        for (c, m, v), rec in sorted(recs.items()):
            if c != cell or m != mesh or rec["status"] != "ok":
                continue
            _, by, co, inter, _ = global_totals(rec)
            t = ra.roofline_terms(1.0, by, co, rec["chips"],
                                  inter_bytes=inter)
            print(f"| {cell} | {v} | {t['memory_s']:.2e} | "
                  f"{t['collective_s']:.2e} | "
                  f"{fmt_bytes(rec['memory'].get('argument_size_in_bytes'))} |"
                  f" {fmt_bytes(rec['memory'].get('temp_size_in_bytes'))} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="gpu16x16")
    ap.add_argument("--variant", default="axllm-int8")
    ap.add_argument("--compare", default="")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--cells", default="")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    if args.compare:
        print_compare(recs, load(args.compare), args.mesh, args.variant)
    elif args.variants:
        cells = args.cells.split(",") if args.cells else sorted(
            {c for (c, m, v) in recs if SHAPES[c.split(":")[1]].kind
             != "train"})
        print_variants(recs, cells, args.mesh)
    else:
        print_roofline(recs, args.mesh, args.variant)


if __name__ == "__main__":
    main()
