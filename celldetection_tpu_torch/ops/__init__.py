from . import draw, loss
from .boxes import (batched_box_nmsi, box_area, box_iou, filter_by_box_voting, get_iou_voting,
                    nms, nms_chunked, nms_indices, nms_padded, pairwise_box_iou,
                    pairwise_generalized_box_iou, remove_small_boxes_mask)
from .commons import (clip, downsample_labels, equal_size, interpolate_nchw, interpolate_vector,
                      minibatch_std_layer, pad_to_div, pad_to_size, padded_stack2d,
                      process_scores, resize_bilinear, resize_nearest, spatial_mean,
                      split_spatially, strided_upsampling2d, values2bins)
from .draw import draw_contours, draw_contours_
from .normalization import pixel_norm
from .cpn import (batched_box_nms, filter_contours_by_stitching_rule, fourier_basis,
                  fouriers2contours, get_scale, order_weighting, refinement_bucket_weight,
                  rel_location2abs_location, remove_border_contours, resolve_refinement_buckets,
                  scale_contours, scale_fourier)

__all__ = ['box_area', 'box_iou', 'nms_padded', 'nms_chunked', 'nms_indices',
           'remove_small_boxes_mask', 'get_iou_voting', 'filter_by_box_voting', 'equal_size',
           'pairwise_box_iou', 'pairwise_generalized_box_iou', 'clip', 'downsample_labels',
           'order_weighting', 'refinement_bucket_weight', 'resolve_refinement_buckets', 'loss',
           'interpolate_nchw', 'process_scores', 'resize_bilinear', 'resize_nearest',
           'batched_box_nms', 'fourier_basis', 'fouriers2contours', 'get_scale',
           'rel_location2abs_location', 'scale_contours', 'scale_fourier',
           'remove_border_contours', 'filter_contours_by_stitching_rule', 'pixel_norm', 'nms',
           'batched_box_nmsi', 'draw', 'draw_contours', 'draw_contours_', 'values2bins',
           'padded_stack2d', 'split_spatially', 'minibatch_std_layer', 'strided_upsampling2d',
           'interpolate_vector', 'pad_to_size', 'pad_to_div', 'spatial_mean']
