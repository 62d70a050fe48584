"""Small sizes of the cells for the benchmark's own tests on the CPU."""

PDE = {"cell": {"traffic": {"train_trajectories": 8,
                            "valid_trajectories": 2, "warmup_steps": 4}},
       "config": {"program": {"model": {"hidden_channels": 8},
                              "data": {"resolution": 32,
                                       "train_cycles": 400}}}}
DDPM = {"cell": {"traffic": {"images": 32, "warmup_steps": 4, "batch": 4,
                             "warmup_batches": 1, "check_batches": 2}},
        "config": {"n_levels": 2, "program": {
            "model": {"ch": 32, "ch_mult": [1, 2], "attn": [1],
                      "num_res_blocks": 1, "use_bf16": False},
            "data": {"batch_size": 4},
            "train": {"num_iterations_list": [0, 1000],
                      "metrics_every_iters": 2},
            "diffusion": {"sample_steps": 2}}}}
