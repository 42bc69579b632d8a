"""Synthetic datasets, LM token batches and the federated partitioners."""
from repro_torch.data.federated import (  # noqa: F401
    FederatedDataset,
    make_federated,
    partition_dirichlet,
    partition_iid,
    partition_label_k,
)
from repro_torch.data.synthetic import (  # noqa: F401
    synth_cifar,
    synth_mnist,
    token_batch,
)
