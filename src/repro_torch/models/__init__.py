from repro_torch.models.gnn import (GNNConfig, forward, init_params,
                                    params_from_numpy, params_to_numpy)

__all__ = ["GNNConfig", "init_params", "forward", "params_from_numpy",
           "params_to_numpy"]
