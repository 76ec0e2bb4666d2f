from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import (
    make_image_dataset, make_lm_dataset, DATASETS,
)

__all__ = ["dirichlet_partition", "make_image_dataset", "make_lm_dataset",
           "DATASETS"]
