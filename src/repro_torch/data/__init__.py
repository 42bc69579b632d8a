"""Synthetic datasets and the federated partitioners."""
from repro_torch.data.federated import (  # noqa: F401
    FederatedDataset,
    make_federated,
    partition_dirichlet,
    partition_iid,
    partition_label_k,
)
from repro_torch.data.synthetic import synth_cifar, synth_mnist  # noqa: F401
