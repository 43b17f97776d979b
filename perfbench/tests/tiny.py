"""Each cell's traffic cut to a size the CPU runs in seconds, for the
tests (the shapes only; the code paths are the cell's own)."""

TINY = {
    "neuro3d.dense_request": {"shape": [1, 8, 48, 48],
                              "check": {"within": 3}},
    "unet3d_wide.dense_slab": {"shape": [1, 12, 64, 64],
                               "check": {"within": 2}},
    "neuro3d.train_fused": {"cubes": [2, 1, 24, 64, 64], "chunk_steps": 4,
                            "warmup_chunks": 1},
    "neuro3d.sweep": {"dataset": [16, 150, 140], "cube_edge": 64,
                      "step": [8, 72, 64],
                      "check": {"blocks": 3, "block": [4, 32, 32]}},
    "tracer.rollout": {"volume": [1, 40, 40, 40], "agents": 8, "steps": 6,
                       "check": {"within": 3}},
}
SEED = 2 ** 31 + 11
