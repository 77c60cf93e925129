"""The parallel layer on torch.distributed: a ('data', 'model') mesh of
ranks, the tensor-parallel senone loss, the sharded step and the
multi-process scheduler (see each module)."""

from kaldi_lstm_tpu_torch.parallel.mesh import (
    MeshPlan,
    make_mesh,
)
from kaldi_lstm_tpu_torch.parallel.sharded_trainer import (
    make_sharded_grouped_train_step,
    make_sharded_train_step,
)
from kaldi_lstm_tpu_torch.parallel.multihost import (
    SyncedScheduler,
    count_batches,
    empty_batch,
    shard_batch_to_mesh,
    shard_group_to_mesh,
)
