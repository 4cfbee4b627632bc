"""K1b + K1c's share of its roofline on one window launch of the cell's
traffic: the last call's camera (ray_frame_inputs), the frame's first
cluster window (tiled.cluster_window over every cluster the tiles'
frusta hit) and trace_windowed from the loop's initial carry (t = BIG,
normals and counters 0); 3 launches queued behind a spin per round, 3
rounds, timed with CUDA events. The least time from the launch's own
unit visits with the compressed derive (fp32 operations over 67 TFLOP/s)
or its bytes (over 3.35 TB/s), the larger. None off the card or where
the scene fits one window (no K1b)."""
import torch

from rtbench import harness, roofline


def read(run, name):
    if run.device.type != "cuda" or run.scene is None:
        return None
    from rtmm_tpu_torch.ops import tile_trace, tiled
    drv, scene = run.driver, run.scene
    cfg = drv.cfg
    kc = tile_trace.clusters_per_window(scene, cfg)
    if scene.num_clusters <= kc:
        return None
    ivps = torch.from_numpy(drv.cameras(max(drv.calls - 1, 0))).to(
        run.device)
    fi, frus, raymat = tile_trace.ray_frame_inputs(scene, ivps[-1], cfg)
    ccand, ccount, centry = tiled.cluster_window(scene, fi.apex,
                                                 fi.cluster_hit, kc)[:3]
    meta, tables, opts = tile_trace.scene_tables(scene)
    n = frus.shape[0]
    dev = frus.device
    carry = (torch.full((n, tile_trace.TILE), tile_trace.BIG,
                        dtype=torch.float32, device=dev),
             torch.zeros((n, 3, tile_trace.TILE), dtype=torch.float32,
                         device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev))

    def launch():
        return tile_trace.trace_windowed(ccand, ccount, centry, frus, raymat,
                                         carry, meta, tables, cfg, **opts)

    out = launch()
    visits = int(out[2].sum())
    moved = roofline.nbytes(ccand, ccount, centry, frus, raymat, meta,
                            tables, opts.get("corners"), *carry, *out)
    bound, by = roofline.k1_bound(visits, moved,
                                  derive=bool(opts.get("compressed")))
    del out
    ms = roofline.queued_ms(launch, reps=3, rounds=3)
    harness.log(f"[{name}] {roofline.card_line()}: {int(ccount.sum())} "
                f"(tile, cluster) slots of {kc} a tile, {visits} visits, "
                f"{moved / 1e6:.2f} MB; bound {bound:.4f} ms ({by}); "
                f"K1b + K1c {ms:.4f} ms queued")
    return 100.0 * bound / ms
