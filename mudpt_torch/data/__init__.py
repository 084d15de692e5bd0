from mudpt_torch.data.datum import Datum, DatasetBase, subsample_classes
from mudpt_torch.data.manager import DataManager

__all__ = ["Datum", "DatasetBase", "subsample_classes", "DataManager"]
