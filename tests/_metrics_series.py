"""The numeric series of a training run's ``metrics.jsonl`` and their
comparison, for the tests that hold a sharded run of the port against a
single-device run (``test_torch_parallel_train.py``,
``test_torch_parallel_axes_train.py``)."""
import json
import os

import numpy as np


def read_metrics(logdir):
    out = {}
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        for line in f:
            for k, v in json.loads(line).items():
                if isinstance(v, (int, float)):
                    out.setdefault(k, []).append(v)
    return out


def assert_close_series(a, b, keys, rtol=2e-4, atol=1e-6):
    for k in keys:
        assert k in a and k in b, (k, sorted(a), sorted(b))
        assert len(a[k]) == len(b[k]), k
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)
