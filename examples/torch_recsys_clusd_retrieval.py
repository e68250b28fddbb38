"""CluSD as a first-class recsys feature on the PyTorch port (the card by
default, `--device cpu` to run on the CPU): score one user against 100k
candidate items with the paper's cluster-selection pipeline (a low-dim
prefix dot as the sparse guide) vs brute force, end to end.

  PYTHONPATH=src python examples/torch_recsys_clusd_retrieval.py [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import kmeans as km
from repro_torch.core.lstm import LSTMSelector
from repro_torch.core.retrieval import (CandidateIndexSpec,
                                        brute_force_retrieval,
                                        clusd_candidate_retrieval)
from repro_torch.data.recsys_stream import RecsysStream
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import recsys as rs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    # dlrm: the guide is a low-dim prefix dot of the item vectors — the
    # correlated cheap scorer the paper's sparse retrieval plays (wide-branch
    # guides only correlate after training; see core/retrieval.py)
    cfg = get_config("dlrm-mlperf", "smoke")
    rng = np.random.default_rng(0)
    params = rs.init_params(cfg, torch.Generator().manual_seed(1),
                            device=dev)
    stream = RecsysStream(cfg, seed=3)
    batch = rs.as_batch({k: v[:1] for k, v in stream.batch(4).items()
                         if k != "label"}, dev)

    # candidate items + cluster-blocked index
    n_cand, n_clusters, cap = 100_000, 256, 512
    cand_raw = torch.from_numpy(np.stack(
        [rng.integers(0, cfg.table_sizes[i], n_cand) for i in range(2)],
        1).astype(np.int32)).to(dev)
    with torch.no_grad():
        item_vecs = rs.candidate_tower(cfg, params, cand_raw)
    cents, assign = km.kmeans(item_vecs, n_clusters, 8,
                              generator=torch.Generator().manual_seed(2),
                              device=dev)
    table, _ = km.build_cluster_table(assign.cpu().numpy(), n_clusters, cap,
                                      item_vecs.cpu().numpy(),
                                      cents.cpu().numpy())
    table = torch.from_numpy(table).to(dev)
    valid = table >= 0
    blocks = torch.zeros((n_clusters, cap, item_vecs.shape[1]), device=dev)
    blocks[valid] = item_vecs[table[valid].long()]
    cand_blocked = torch.zeros((n_clusters * cap, 2), dtype=torch.int32,
                               device=dev)
    cand_blocked[valid.reshape(-1)] = cand_raw[table[valid].long()]
    nb_ids, nb_sims = km.neighbor_graph(cents, 64)

    # untrained demo selector: keep all 32 stage-1 candidates (selection
    # quality with a TRAINED LSTM is exercised in tests/benchmarks); alpha
    # low because the untrained guide is only rank-correlated, not calibrated
    spec = CandidateIndexSpec(n_candidates=n_cand, n_clusters=n_clusters,
                              cap=cap, k_guide=1024, max_selected=32,
                              alpha=0.2, k_final=100)
    lstm = LSTMSelector(1 + spec.u_bins + 2 * spec.v_bins, 32,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    slot_valid = valid.reshape(-1).contiguous()

    def bf():
        return brute_force_retrieval(cfg, params, batch, blocks, k=100)

    def cs():
        return clusd_candidate_retrieval(cfg, spec, params, batch,
                                         cand_blocked, blocks, cents, lstm,
                                         nb_ids, nb_sims,
                                         slot_valid=slot_valid)

    with torch.no_grad():
        bf()
        t0 = time.perf_counter()
        ids_b, _ = bf()
        synchronize(dev)
        t_b = time.perf_counter() - t0
        cs()
        t0 = time.perf_counter()
        ids_c, _, diag = cs()
        synchronize(dev)
        t_c = time.perf_counter() - t0

    n_sel = int(diag["n_selected"])
    overlap = len(set(ids_b.cpu().numpy().ravel()[:100].tolist())
                  & set(ids_c.cpu().numpy().ravel()[:100].tolist())) / 100
    print(f"brute force: {t_b*1e3:.1f} ms; CluSD-guided: {t_c*1e3:.1f} ms "
          f"(untrained selector, {n_sel} clusters = {n_sel * cap} of "
          f"{n_cand} items scored)")
    print(f"top-100 overlap vs brute force: {overlap:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
