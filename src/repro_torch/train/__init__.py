from repro_torch.train.optimizer import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
    lr_schedule,
)
from repro_torch.train.grad_compression import (  # noqa: F401
    compress_int8,
    decompress_int8,
    init_residuals,
    make_compressed_psum,
)
from repro_torch.train.trainer import (  # noqa: F401
    Trainer,
    TrainState,
    loss_and_grads,
    make_train_step,
)
