from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.data.specs import batch_specs, make_batch

__all__ = ["SyntheticDataset", "batch_specs", "make_batch"]
