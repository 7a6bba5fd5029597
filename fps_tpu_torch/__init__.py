"""fps_tpu_torch: the PyTorch/CUDA port of fps_tpu, for NVIDIA Hopper.

A second package beside ``fps_tpu`` (the JAX reference, which it never
imports). It runs on a ``(data, shard)`` mesh driven by one process (each
position a device, positions may share one), in sync and SSP modes:
``make_ps_mesh`` →
a model constructor (``online_mf``, ``passive_aggressive``,
``logistic_regression``, ``word2vec``, ``word2vec_block``) →
``Trainer.init_state`` → ``DeviceDataset`` + ``DeviceEpochPlan`` (word2vec:
``Word2VecDevicePlan``) → ``run_indexed`` (or ``fit_stream`` /
``run_chunk`` over chunks). On a CUDA device every pull and push runs on the port's
hand-written kernels (``fps_tpu_torch/ops/csrc``: row gather and scatter-add
for wide tables, the head scatter-add of the hot/cold push split, scalar
gather and scatter-add for ``(R, 1)`` tables); on the CPU, on their plain
PyTorch versions. iALS (``IALSSolver``) drives its own loop of
normal-equation solves over the same store and kernels, and top-k retrieval
(``models.recommendation``) ranks a sharded table where it lies; every
model family runs on any mesh.

Entry points run on the visible CUDA devices unless ``device="cpu"`` is
passed to :func:`make_ps_mesh`; without CUDA and without a device they
raise.
"""

from fps_tpu_torch.core.api import (
    ADDITIVE,
    MEAN_COMBINE,
    ServerLogic,
    StepOutput,
    WorkerLogic,
)
from fps_tpu_torch.core.device_ingest import (
    DeviceDataset,
    DeviceEpochPlan,
    device_epoch_chunks,
)
from fps_tpu_torch.core.driver import Trainer, TrainerConfig
from fps_tpu_torch.core.store import ParamStore, TableSpec, pull, push
from fps_tpu_torch.models.ials import IALSConfig, IALSSolver
from fps_tpu_torch.models.logistic_regression import (
    LogRegConfig,
    logistic_regression,
)
from fps_tpu_torch.models.matrix_factorization import MFConfig, online_mf
from fps_tpu_torch.models.passive_aggressive import (
    PAConfig,
    passive_aggressive,
)
from fps_tpu_torch.models.word2vec import (
    W2VConfig,
    Word2VecDevicePlan,
    word2vec,
    word2vec_block,
)
from fps_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SHARD_AXIS,
    Blocks,
    default_mesh_shape,
    make_ps_mesh,
    num_workers_of,
)

__all__ = [
    "ADDITIVE", "Blocks", "DATA_AXIS", "DeviceDataset", "DeviceEpochPlan",
    "IALSConfig", "IALSSolver", "LogRegConfig", "MEAN_COMBINE", "MFConfig", "PAConfig", "ParamStore",
    "SHARD_AXIS", "ServerLogic", "StepOutput", "TableSpec", "Trainer",
    "TrainerConfig", "W2VConfig", "Word2VecDevicePlan", "WorkerLogic",
    "default_mesh_shape", "device_epoch_chunks", "logistic_regression",
    "make_ps_mesh", "num_workers_of", "online_mf", "passive_aggressive",
    "pull", "push", "word2vec", "word2vec_block",
]
