"""Host-side data: image normalisation, the CPN training-target pipeline,
contour rendering, instance matching, toy data, augmentations, transforms
and datasets (numpy, scipy).

Nothing here imports cv2 or scikit-image: contour tracing, the distance
transform, the polygon fill, the dilation, the drawing primitives, the
Gaussian blur and the remap have numpy versions of their own (:mod:`.cpn`,
:mod:`._draw`). h5py, imageio and yaml are imported only by the functions
that read such files.
"""
from . import augmentation, datasets, toydata, transforms
from .augmentation import Compose, conf2augmentation
from .cpn import (CPNTargetGenerator, chamfer_distance, clip_contour_, contours2boxes,
                  contours2fourier, contours2labels, contours2properties, draw_contours, efd,
                  filter_contours_by_intensity, fourier2contour, labels2contour_list,
                  labels2contours, labels2distances, mask_labels_by_distance_, masks2labels,
                  outer_borders, render_contour, resolve_label_channels)
from .instance_eval import LabelMatcher, LabelMatcherList, matching_labels
from .misc import (channels_first2channels_last, channels_last2channels_first, labels2crops,
                   normalize_percentile, pad_to_div, pad_to_size, padding_stack, random_crop,
                   random_pad, resample_contours, rgb_to_scalar, rle2mask, split,
                   transpose_spatial, universal_dict_collate_fn)
from .segmentation import (boxes2masks, fill_label_gaps_, fill_padding_, filter_instances_,
                           relabel_, remove_padding, remove_partials_, stack_labels,
                           unary_masks2labels)
from .targets import CPNTrainItem, collate_cpn_targets, cpn_targets_single
from .toydata import (CLASS_NAMES_GEOMETRIC, random_circle, random_ellipse,
                      random_geometric_objects, random_geometric_shapes, random_rectangle,
                      random_triangle, synthetic_cells)
from .transforms import BasicTransforms, Transforms

__all__ = ['normalize_percentile', 'random_crop', 'random_pad', 'resample_contours',
           'rgb_to_scalar', 'remove_partials_', 'fill_label_gaps_', 'filter_instances_',
           'fill_padding_', 'remove_padding', 'relabel_', 'stack_labels', 'unary_masks2labels',
           'boxes2masks', 'CPNTargetGenerator',
           'efd', 'fourier2contour', 'labels2contours', 'contours2fourier',
           'mask_labels_by_distance_', 'labels2distances', 'outer_borders', 'chamfer_distance',
           'cpn_targets_single', 'collate_cpn_targets', 'CPNTrainItem', 'contours2boxes',
           'render_contour', 'clip_contour_', 'contours2labels', 'resolve_label_channels',
           'LabelMatcher', 'LabelMatcherList', 'matching_labels', 'random_geometric_objects',
           'random_geometric_shapes', 'synthetic_cells', 'random_circle', 'random_ellipse',
           'random_rectangle', 'random_triangle', 'CLASS_NAMES_GEOMETRIC', 'Compose',
           'conf2augmentation', 'Transforms', 'BasicTransforms', 'augmentation', 'datasets',
           'toydata', 'transforms', 'labels2contour_list', 'masks2labels', 'contours2properties',
           'filter_contours_by_intensity', 'draw_contours', 'channels_first2channels_last',
           'channels_last2channels_first', 'transpose_spatial', 'padding_stack',
           'universal_dict_collate_fn', 'rle2mask', 'pad_to_size', 'pad_to_div', 'split',
           'labels2crops']
