"""Host-side data: image normalisation, the CPN training-target pipeline,
contour rendering and instance matching (numpy, scipy).

Nothing here imports cv2 or scikit-image: contour tracing, the distance
transform, the polygon fill and the dilation have numpy versions of their
own (:mod:`.cpn`).
"""
from .cpn import (CPNTargetGenerator, chamfer_distance, clip_contour_, contours2boxes,
                  contours2fourier, contours2labels, efd, fourier2contour, labels2contours,
                  labels2distances, mask_labels_by_distance_, outer_borders, render_contour,
                  resolve_label_channels)
from .instance_eval import LabelMatcher, LabelMatcherList, matching_labels
from .misc import normalize_percentile, random_crop, random_pad, resample_contours
from .segmentation import fill_label_gaps_, filter_instances_, remove_partials_
from .targets import CPNTrainItem, collate_cpn_targets, cpn_targets_single

__all__ = ['normalize_percentile', 'random_crop', 'random_pad', 'resample_contours',
           'remove_partials_', 'fill_label_gaps_', 'filter_instances_', 'CPNTargetGenerator',
           'efd', 'fourier2contour', 'labels2contours', 'contours2fourier',
           'mask_labels_by_distance_', 'labels2distances', 'outer_borders', 'chamfer_distance',
           'cpn_targets_single', 'collate_cpn_targets', 'CPNTrainItem', 'contours2boxes',
           'render_contour', 'clip_contour_', 'contours2labels', 'resolve_label_channels',
           'LabelMatcher', 'LabelMatcherList', 'matching_labels']
