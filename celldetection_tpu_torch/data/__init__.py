"""Host-side data: image normalisation and the CPN training-target pipeline (numpy, scipy).

Nothing here imports cv2 or scikit-image: contour tracing and the distance
transform have numpy versions of their own (:mod:`.cpn`).
"""
from .cpn import (CPNTargetGenerator, chamfer_distance, contours2fourier, efd, fourier2contour,
                  labels2contours, labels2distances, mask_labels_by_distance_, outer_borders)
from .misc import normalize_percentile, random_crop, random_pad, resample_contours
from .segmentation import fill_label_gaps_, filter_instances_, remove_partials_
from .targets import CPNTrainItem, collate_cpn_targets, cpn_targets_single

__all__ = ['normalize_percentile', 'random_crop', 'random_pad', 'resample_contours',
           'remove_partials_', 'fill_label_gaps_', 'filter_instances_', 'CPNTargetGenerator',
           'efd', 'fourier2contour', 'labels2contours', 'contours2fourier',
           'mask_labels_by_distance_', 'labels2distances', 'outer_borders', 'chamfer_distance',
           'cpn_targets_single', 'collate_cpn_targets', 'CPNTrainItem']
