"""The paper's Fig. 1 -> Fig. 14 loop, end to end, on the PyTorch/CUDA port.

The twin of ``examples/characterize_and_place.py``:

  1. characterize every (pool x strategy x contention) performance curve,
  2. hand the curve database to the PlacementAdvisor,
  3. place a serving workload's memory objects (params, KV cache) under
     two contention assumptions and watch the decision flip,
  4. sweep a full bandwidth–latency surface (CurveDB v3) and query it
     at the decode workload's actual traffic coordinates,
  5. hunt the worst contention corner with the worst-case search, which
     executes every probe batch as one launch of the contention ladder,
     and place pessimistically against its envelope.

    python examples/torch/characterize_and_place.py                # card
    python examples/torch/characterize_and_place.py --device cpu   # plain

Steps 1–4 run the ``cuda`` backend (the observer measured by its kernel,
the contended rungs modeled), step 5 the ``spmd`` backend (observer and
stressors executed together).  The capacities are the H100 SXM's own
(``H100_SXM``).  With ``--device cpu`` every kernel's plain PyTorch version
runs, at sizes the CPU finishes.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.characterize import (characterize,  # noqa: E402
                                           characterize_surface, mlp_table)
from repro_torch.core.coordinator import CoreCoordinator  # noqa: E402
from repro_torch.core.devicetree import H100_SXM  # noqa: E402
from repro_torch.core.placement import (ContentionSpec,  # noqa: E402
                                        MemObject, PlacementAdvisor,
                                        kv_cache_object, params_object)
from repro_torch.core.pools import PoolManager  # noqa: E402
from repro_torch.core.search import (SearchSpec,  # noqa: E402
                                     worst_case_search)
from repro_torch.serve.engine import cache_bytes, decode_rw_mix  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    # above the 50 MB L2, so that the curves characterize each memory and
    # not the cache in front of it; the executed search on the CPU runs
    # the ladder's plain version engine by engine, so it stays small there
    buf = 64 << 20
    search_buf = buf if on_card else (64 << 10)
    iters = 20 if on_card else 1

    coord = CoreCoordinator(PoolManager(H100_SXM, args.device), H100_SXM,
                            device=args.device)      # backend "cuda"

    print(f"== 1. characterize (full ladder cross-product, {args.device}) ==")
    db = characterize(coord, pools=["hbm", "host"],
                      obs_strategies=("r", "w", "l"),
                      stress_strategies=("r", "w", "y"),
                      buffer_bytes=buf, iters=iters)
    print(f"curves collected: {len(db.curves)}")
    path = os.path.join(tempfile.mkdtemp(), "memscope_curves.json")
    db.save(path)
    print(f"persisted to {path} (reloadable: CurveDB.load)")

    print("\n== 2. Little's-law MLP per pool ==")
    print(mlp_table(db, coord.platform))

    print("\n== 3. placement decisions ==")
    cfg = get_config("glm4-9b")
    adv = PlacementAdvisor(db, coord.platform, pools=["hbm", "host"])
    kv = kv_cache_object("kv_cache", cache_bytes(cfg, batch=32, max_len=32768),
                         bytes_read_per_token=float(
                             cache_bytes(cfg, 32, 32768)))
    objs = [
        params_object("params", 2 * cfg.n_params(), reads_per_step=1.0),
        kv,
        MemObject("activations", 8 << 30, bytes_per_step=float(16 << 30)),
    ]
    # one H100 SXM's device memory and the host memory its tree declares
    caps = {p: H100_SXM.memories[p].size_bytes for p in ("hbm", "host")}

    for label, contention in (
            ("quiet system", ContentionSpec(0, "hbm", "w")),
            ("7 writers hammering HBM", ContentionSpec(7, "hbm", "y"))):
        plan = adv.advise(objs, contention, capacities=dict(caps))
        print(f"\n-- contention: {label}")
        print(plan.report())
        print(f"   predicted step total: "
              f"{plan.total_predicted_ns() / 1e6:.2f} ms")

    print("\n== 4. bandwidth-latency surface (CurveDB v3) ==")
    sdb = characterize_surface(coord, pools=["hbm", "host"],
                               stress_pools=["hbm"], buffer_bytes=buf,
                               iters=iters)
    key, surf = next(iter(sorted(sdb.surfaces.items())))
    print(f"surfaces: {len(sdb.surfaces)}; {key.to_string()!r} grid shape "
          f"{surf.shape} (n_stressors x rw_ratio x inject_rate)")
    mix = decode_rw_mix(batch=32, max_len=32768)
    q = sdb.query("hbm", 3, stress_strat="b", rw_ratio=mix, inject_rate=0.8)
    print(f"decode mix rw={mix:.3f}, 3 stressors at 80% duty -> "
          f"{q.bandwidth_gbps:.1f} GB/s "
          f"(interpolated; extrapolated={q.extrapolated})")
    q_off = sdb.query("hbm", 99, stress_strat="b")
    print(f"off-grid (99 stressors) -> {q_off.bandwidth_gbps:.1f} GB/s, "
          f"flagged extrapolated={q_off.extrapolated}")
    adv_s = PlacementAdvisor(sdb, coord.platform)
    plan = adv_s.advise([kv], ContentionSpec(3, "hbm", "b", rw_ratio=mix),
                        capacities=dict(caps))
    print("placement at the decode surface coordinates:")
    print(plan.report())

    print("\n== 5. worst-case search, then pessimistic placement ==")
    spmd = CoreCoordinator(PoolManager(H100_SXM, args.device), H100_SXM,
                           backend="spmd", device=args.device)
    spec = SearchSpec(pool="hbm", buffer_bytes=search_buf, iters=1,
                      iterations=6,
                      batch=4 if on_card else 2, max_stressors=7, seed=0)
    res = worst_case_search(spmd, spec, db)
    st = res.stats
    print(f"{spec.iterations} iterations -> {st.host_sync_dispatches} "
          f"ladder launches ({st.noisy_remeasures} re-measured), "
          f"{len(res.points)} probes, executed={res.executed}, "
          f"fenced={res.fenced}")
    for t in res.trace:
        print(f"   iteration {t['iteration']}: arm {t['arm']:7s} "
              f"reward {t['reward']:9.3f}  model gap {t['model_gap']:.3f}")
    for o in spec.obs_strategies:
        w = res.worst(o)
        val = (f"{w.latency_ns:.1f} ns/hop" if o == "l"
               else f"{w.bandwidth_gbps:.2f} GB/s")
        print(f"worst {o}: {val} under {w.n_stressors} x {w.arm} "
              f"(rw={w.rw_ratio}, duty={w.inject_rate})")
    for k in res.install(db):
        print(f"installed envelope {k.to_string()!r}")
    adv_p = PlacementAdvisor(db, coord.platform, pools=["hbm", "host"],
                             pessimistic=True)
    plan = adv_p.advise(objs, ContentionSpec(7, "hbm", "y"),
                        capacities=dict(caps))
    print("pessimistic placement, 7 stressors of any mix:")
    print(plan.report())
    print(f"   predicted step total: "
          f"{plan.total_predicted_ns() / 1e6:.2f} ms")


if __name__ == "__main__":
    main()
