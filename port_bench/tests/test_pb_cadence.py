"""The harness's copy of the trainer's chunking equals the trainer's."""

from __future__ import annotations

import types

import pytest
import torch

from gstex_torch.models.gstex import GStexConfig
from gstex_torch.train.trainer import Trainer, TrainerConfig

from port_bench import cadence


def trainer_like(tcfg, mcfg):
    state = types.SimpleNamespace(params=types.SimpleNamespace(
        means=torch.zeros(1, 3)))
    return types.SimpleNamespace(tcfg=tcfg, mcfg=mcfg, viewer=None,
                                 pose=None, state=state)


@pytest.mark.parametrize("sync", [1, 2, 8, 13])
def test_chunk_size_equals_the_trainers(sync):
    # the trainer's defaults, eval images and saves included: their
    # cadences are multiples of log_every, so leaving them out of the
    # window moves no chunk boundary
    tcfg = TrainerConfig(steps_per_sync=sync, max_num_iterations=15000)
    mcfg = GStexConfig(renderer="pallas")
    fake = trainer_like(tcfg, mcfg)
    for step in list(range(0, 450)) + list(range(2950, 3400)) + \
            list(range(14980, 15000)):
        assert cadence.chunk_size(
            step, sync, (mcfg.build_chart_every, tcfg.log_every),
            tcfg.max_num_iterations) == Trainer._chunk_size(fake, step), step


def test_the_window_runs_eight_two_eight_two():
    sizes, step = [], 3011
    while step < 3041:
        n = cadence.chunk_size(step, 8, (100, 10), 15000)
        sizes.append(n)
        step += n
    assert sizes == [8, 2, 8, 2, 8, 2]
