"""The port's synthetic template bank is the reference's, feature for
feature, for the same seed (bench.py's 12 x 10 bank and a small one)."""

import numpy as np
import pytest

from object_detector_6d_tpu.data.synthetic import synthetic_bank as ref_synthetic_bank
from object_detector_6d_tpu_torch.data.synthetic import synthetic_bank


@pytest.mark.parametrize("n_classes,per_class,bbox_px,seed", [(12, 10, 120, 0), (2, 3, 80, 5)])
def test_synthetic_bank_equals_reference(n_classes, per_class, bbox_px, seed):
    ref = ref_synthetic_bank(n_classes=n_classes, per_class=per_class, bbox_px=bbox_px,
                             seed=seed)
    got = synthetic_bank(n_classes=n_classes, per_class=per_class, bbox_px=bbox_px, seed=seed)
    assert got.modality_names == ref.modality_names
    assert list(got.class_templates) == list(ref.class_templates)
    for cid, pyrs in ref.class_templates.items():
        assert len(got.class_templates[cid]) == len(pyrs)
        for gp, rp in zip(got.class_templates[cid], pyrs):
            assert [len(t.features) for t in gp] == [63, 63, 31, 31]
            for g, r in zip(gp, rp):
                assert (g.width, g.height, g.pyramid_level) == (r.width, r.height, r.pyramid_level)
                np.testing.assert_array_equal(g.feature_array(), r.feature_array())
