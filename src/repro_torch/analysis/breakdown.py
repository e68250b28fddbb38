"""Per-collective breakdown of a dry-run cell: which collectives move
the bytes, by (kind, shape, op), the op being the innermost frame of
this package that issued it (outside models/collectives.py); the JAX
package's `repro.analysis.breakdown`. Depth is extrapolated from two
neighbouring depths as the dry run does.

Usage:
  PYTHONPATH=src python -m repro_torch.analysis.breakdown --arch arctic-480b \\
      --shape train_4k [--multi] [--set moe_impl=ep_shard_map] [--top 15]
"""

import argparse
from collections import Counter


def collective_breakdown(sites, top=15):
    """The `top` largest entries of {(kind, shape, op): wire bytes}
    (CostMode.collective_sites), largest first."""
    return Counter(sites).most_common(top)


def cell_sites(arch, shape, multi_pod, overrides=None, mesh=None,
               variant="full"):
    """({(kind, shape, op): wire bytes per rank}, total collective dict)
    of a cell at its config's depth."""
    from repro_torch.analysis.cost import extrapolate
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import build_cell, cell_config

    if mesh is None:
        mesh = dryrun.production_mesh(multi_pod)
    full = cell_config(arch, overrides, variant)
    runs = []
    for depth in dryrun._depths(full):
        o = dict(overrides or {})
        if depth is not None:
            o["n_layers"] = depth
        cell = build_cell(arch, shape, mesh, multi_pod, o, variant)
        mode, _ = dryrun.count_cell(cell, mesh, multi_pod, cell.rules)
        runs.append(({"|".join(k): v for k, v in
                      mode.collective_sites.items()}, mode.collectives()))
    if len(runs) == 2:
        lo = dryrun._depths(full)[0]
        sites = extrapolate(runs[0][0], runs[1][0], full.n_layers, lo)
        total = extrapolate(runs[0][1], runs[1][1], full.n_layers, lo)
    else:
        sites, total = runs[0]
    return ({tuple(k.split("|", 2)): v for k, v in sites.items()}, total)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides key=value")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import shapes_for
    from repro_torch.launch.dryrun import parse_value

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=")
        overrides[k] = parse_value(v)
    shape = shapes_for(get_config(args.arch).family)[args.shape]
    sites, total = cell_sites(args.arch, shape, args.multi, overrides)
    print(f"total wire {total.get('wire', 0)/2**30:.2f} GiB/device "
          f"({total.get('count', 0):.0f} collective sites)")
    for (kind, shape_s, op), wire in collective_breakdown(sites, args.top):
        print(f"{wire/2**30:9.2f} GiB  {kind:18s} {shape_s:45s} {op}")


if __name__ == "__main__":
    main()
