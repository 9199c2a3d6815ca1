"""Live renderer: a per-OA exposure choropleth animated while the
simulation steps.

The port's copy of ``epidemicsimulator_tpu/viz/live.py``, the
matplotlib-animation stand-in for the reference's feature-gated ggez
window (visualisation/src/live_render.rs:37-49; its CLI mode is
``unimplemented!``, run/src/main.rs:212-213): it steps the simulation
chunk by chunk on ``device`` and writes one GIF frame per chunk.
matplotlib and PIL are imported inside the function.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def render_live(
    world,
    params,
    cfg,
    rings,
    ring_starts,
    *,
    out_path: str = "live.gif",
    frames: int = 100,
    steps_per_frame: int = 24,
    seed: int = 0,
    device="cuda",
):
    """Run ``frames`` chunks of ``steps_per_frame`` steps (stopping after
    the chunk in which the epidemic ends) and write their frames to
    ``out_path``: each OA coloured by log(1 + its exposures so far), the
    title the hour and the last step's S/E/I/R/V."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import PolyCollection
    from PIL import Image

    from ..engine.scan import make_chunk_runner
    from ..engine.state import init_state
    from ..runtime import resolve_device

    cfg = dataclasses.replace(
        cfg, chunk_size=steps_per_frame, record_exposures_per_oa=True
    )
    wd = world.to(resolve_device(device))
    chunk_fn = make_chunk_runner(wd, cfg)
    state = init_state(wd, seed=seed, starting_infected=cfg.starting_infected,
                       device=device)

    polys = [
        rings[ring_starts[i]: ring_starts[i + 1]]
        for i in range(len(ring_starts) - 1)
    ]
    fig, ax = plt.subplots(figsize=(8, 8))
    pc = PolyCollection(polys, edgecolor="black", linewidth=0.2)
    pc.set_cmap("inferno")
    pc.set_array(np.zeros(len(polys)))
    ax.add_collection(pc)
    ax.autoscale()
    ax.set_aspect("equal")
    title = ax.set_title("hour 0")

    oa_exposed = np.zeros(world.n_output_areas)

    images = []
    for _frame in range(frames):
        state, out = chunk_fn(params, state)
        exp = out.exposures_per_oa.cpu().numpy()
        if exp.size:
            oa_exposed = oa_exposed + exp.sum(axis=0)
        pc.set_array(np.log1p(oa_exposed[: len(polys)]))
        seirv = out.seirv[-1].cpu().numpy()
        title.set_text(f"hour {int(state.hour)}  S/E/I/R/V: {seirv.tolist()}")
        fig.canvas.draw()
        images.append(
            Image.fromarray(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
        )
        if seirv[0] + seirv[1] + seirv[2] == 0:
            break
    plt.close(fig)
    images[0].save(
        out_path, save_all=True, append_images=images[1:], duration=100, loop=0
    )
    return out_path
