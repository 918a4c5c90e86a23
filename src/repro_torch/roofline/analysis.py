"""Roofline aggregation over the port's dry-run records, for one NVIDIA
H100: the per-(arch x shape x mesh) three-term roofline table, the
dominant term of each cell, and the MODEL_FLOPS / counted-FLOPs
usefulness ratio — the reference's ``roofline/analysis.py`` over
``repro_torch.configs``.

    PYTHONPATH=src python -m repro_torch.roofline.analysis \
        [--dir experiments/dryrun_torch] [--markdown out.md]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from .collect import HBM_BW, ICI_BW, PEAK_FLOPS, roofline_terms


def model_flops(rec: dict) -> float | None:
    """Analytic MODEL_FLOPS per step: 6·N·D (dense) / 6·N_active·D (MoE)
    for LM training; 2·N·D for prefill; 2·N_active·B for decode; GNN/BST:
    2 x parameter-matmul flops x items."""
    from repro_torch.configs import get_arch

    try:
        spec = get_arch(rec["arch"])
    except Exception:  # noqa: BLE001
        return None
    dims = rec.get("dims", {})
    if spec.family == "lm":
        cfg = spec.config
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
        attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
            + cfg.n_heads * hd * d
        if cfg.is_moe:
            ffn = cfg.top_k * 3 * d * f
        else:
            ffn = 3 * d * f
        n_active = cfg.n_layers * (attn + ffn) + cfg.vocab_size * d
        if rec["kind"] == "train":
            tokens = dims["global_batch"] * dims["seq_len"]
            return 6.0 * n_active * tokens
        if rec["kind"] == "prefill":
            tokens = dims["global_batch"] * dims["seq_len"]
            return 2.0 * n_active * tokens
        if rec["kind"] == "decode":
            # one token per sequence + attention over the cache
            b, t = dims["global_batch"], dims["seq_len"]
            attn_cache = (cfg.n_layers * 2 * 2 * t
                          * cfg.n_kv_heads * hd)
            return b * (2.0 * n_active + attn_cache)
    if spec.family == "gnn":
        cfg = spec.config
        dd = cfg.d_hidden
        if "pad_nodes" in dims:  # sampled shape: the subgraph, not the graph
            n, e = dims["pad_nodes"], dims["pad_edges"]
        else:
            n, e = dims.get("n_nodes", 0), dims.get("n_edges", 0)
        if rec["shape"] == "molecule":
            n *= dims.get("batch", 1)
            e *= dims.get("batch", 1)
        # per-arch dominant matmul costs (fwd), x3 for train (fwd+bwd)
        per_edge = {"gatedgcn": 6 * dd * dd, "egnn": 8 * dd * dd,
                    "graphcast": 8 * dd * dd,
                    "mace": 2 * (3 * cfg.n_rbf * dd + 15 * dd)}[cfg.arch]
        per_node = {"gatedgcn": 4 * dd * dd, "egnn": 6 * dd * dd,
                    "graphcast": 6 * dd * dd, "mace": 20 * dd * dd}[cfg.arch]
        return 3.0 * 2.0 * cfg.n_layers * (e * per_edge + n * per_node) / 2
    if spec.family == "recsys":
        cfg = spec.config
        b = dims.get("batch", 1)
        dm = 2 * cfg.embed_dim
        blk = cfg.seq_len * (4 * dm * dm + 2 * dm * cfg.d_ff) \
            + 2 * cfg.seq_len * cfg.seq_len * dm
        mlp_in = cfg.seq_len * dm + cfg.embed_dim
        dims_mlp = (mlp_in,) + cfg.mlp_dims + (1,)
        mlp = sum(dims_mlp[i] * dims_mlp[i + 1] for i in range(len(dims_mlp) - 1))
        fwd = 2.0 * b * (blk + mlp)
        return 3.0 * fwd if rec["kind"] == "train" else fwd
    return None


def load_records(d: str) -> list:
    recs = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def table(recs: list) -> list:
    rows = []
    for r in recs:
        if r["status"] == "skipped":
            rows.append({"arch": r["arch"], "shape": r["shape"],
                         "mesh": r["mesh"], "status": "SKIP",
                         "note": r.get("skip_reason", "")[:60]})
            continue
        if r["status"] != "ok":
            rows.append({"arch": r["arch"], "shape": r["shape"],
                         "mesh": r["mesh"], "status": "FAIL",
                         "note": r.get("error", "")[:60]})
            continue
        mf = model_flops(r)
        t = roofline_terms(r, model_flops=mf)
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "status": "ok",
            "hbm_gb": r.get("per_device_hbm_gb"),
            "t_compute": t["t_compute_s"], "t_memory": t["t_memory_s"],
            "t_coll": t["t_collective_s"], "dominant": t["dominant"],
            "bound_s": t["bound_s"],
            "useful_frac": t.get("useful_flop_frac"),
            "coll_gb": r.get("collectives", {}).get("total_bytes", 0) / 2**30,
        })
    return rows


def to_markdown(rows: list) -> str:
    out = ["| arch | shape | mesh | GB/dev | t_comp (s) | t_mem (s) | "
           "t_coll (s) | dominant | useful FLOP frac |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r['status']}: {r['note']} | | | | | |")
            continue
        uf = f"{r['useful_frac']:.2f}" if r.get("useful_frac") else "-"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['hbm_gb']} | "
            f"{r['t_compute']:.4f} | {r['t_memory']:.4f} | "
            f"{r['t_coll']:.4f} | **{r['dominant']}** | {uf} |")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--markdown", default=None)
    args = ap.parse_args()
    rows = table(load_records(args.dir))
    md = to_markdown(rows)
    print(md)
    ok = [r for r in rows if r["status"] == "ok"]
    doms = {}
    for r in ok:
        doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    print(f"\n{len(ok)} ok cells; dominant terms: {doms}")
    print(f"constants: one NVIDIA H100 80GB HBM3 (SXM, 700 W): "
          f"{PEAK_FLOPS/1e12:.0f} TF/s bf16, {HBM_BW/1e9:.0f} GB/s HBM, "
          f"{ICI_BW/1e9:.0f} GB/s NVLink (no collective on one card)")
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(md + "\n")


if __name__ == "__main__":
    main()
