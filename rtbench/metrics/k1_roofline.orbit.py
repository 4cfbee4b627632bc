"""K1a's share of its roofline on one launch of the cell's traffic: the
last call's batch of frames launched again (frames_inputs, then
trace_fused), 20 launches queued behind a spin per round and timed with
CUDA events; the least time from the launch's own unit visits (fp32
operations over 67 TFLOP/s) or its bytes (over 3.35 TB/s), the larger.
None off the card or where the scene takes cluster windows (no K1a)."""
import torch

from rtbench import harness, roofline


def read(run, name):
    if run.device.type != "cuda" or run.scene is None:
        return None
    from rtmm_tpu_torch.ops import culling, tile_trace, tiled
    drv, scene = run.driver, run.scene
    cfg = drv.cfg
    kc = tile_trace.clusters_per_window(scene, cfg)
    if scene.num_clusters > kc or not cfg.kernel_raygen:
        return None
    ivps = torch.from_numpy(drv.cameras(max(drv.calls - 1, 0))).to(
        run.device)
    f = tile_trace.frames_per_launch(cfg, ivps.shape[0])
    rows = tile_trace.frames_inputs(scene, ivps[:f], cfg, kc)
    meta, tables, opts = tile_trace.scene_tables(scene)
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    tx = pw // culling.TILE_W
    per_frame = tx * (ph // culling.TILE_H)

    def launch():
        return tile_trace.trace_fused(*rows, meta, tables, cfg,
                                      tiles_per_frame=per_frame, tx=tx,
                                      pw=pw, ph=ph, **opts)

    out = launch()
    visits = int(out[1].sum())
    moved = roofline.nbytes(*rows, meta, tables, opts.get("corners"), *out)
    bound, by = roofline.k1_bound(visits, moved,
                                  derive=bool(opts.get("compressed")))
    del out
    ms = roofline.queued_ms(launch, reps=20, rounds=3)
    harness.log(f"[{name}] {roofline.card_line()}: {f} frames, {visits} "
                f"visits, {moved / 1e6:.2f} MB; bound {bound:.4f} ms "
                f"({by}); K1a {ms:.4f} ms queued")
    return 100.0 * bound / ms
