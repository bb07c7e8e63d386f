from pcf_torch.train.loss import cross_entropy_loss
from pcf_torch.train.metrics import intersection_and_union
from pcf_torch.train import lr
