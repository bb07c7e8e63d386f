"""Models."""

from pcf_torch.models.backbone import PCF_Backbone
from pcf_torch.models.segmentation import PointConvFormer_Segmentation
from pcf_torch.models.zoo import PCF_Large, PCF_Normal, PCF_Small, PCF_Tiny
