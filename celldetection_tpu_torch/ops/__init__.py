from .boxes import box_area, nms_padded
from .commons import equal_size, interpolate_nchw, process_scores, resize_bilinear, resize_nearest
from .cpn import (batched_box_nms, fourier_basis, fouriers2contours, get_scale,
                  rel_location2abs_location, scale_contours, scale_fourier)

__all__ = ['box_area', 'nms_padded', 'equal_size', 'interpolate_nchw', 'process_scores',
           'resize_bilinear', 'resize_nearest', 'batched_box_nms', 'fourier_basis',
           'fouriers2contours', 'get_scale', 'rel_location2abs_location', 'scale_contours',
           'scale_fourier']
