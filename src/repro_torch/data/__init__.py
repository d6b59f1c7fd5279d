from repro_torch.data.synthetic import make_image_dataset, make_token_dataset
from repro_torch.data.partition import dirichlet_partition, label_histogram
from repro_torch.data.pipeline import (BatchLoader, prefetch_client,
                                       prefetch_steps)
