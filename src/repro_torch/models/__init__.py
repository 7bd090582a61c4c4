from repro_torch.models.gnn import (GNNConfig, batch_to_device, forward,
                                    init_params, loss_and_grads, loss_fn,
                                    make_train_step, params_from_numpy,
                                    params_to_numpy)

__all__ = ["GNNConfig", "init_params", "forward", "loss_fn",
           "loss_and_grads", "make_train_step", "batch_to_device",
           "params_from_numpy", "params_to_numpy"]
