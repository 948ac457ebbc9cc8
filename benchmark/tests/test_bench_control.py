"""On the card: the control (the reference in the program's place with
TF32 matmuls, the next precision below the configurations' full f32)
comes out not correct under each cell's limits, at the cell's widths
and a library cut to what a test run holds."""
import pytest
import torch

from benchmark import control, manifest

DOC = manifest.load()


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in DOC["workloads"]])
def test_control_fails_a_limit(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 matmuls run "
                    "on the card")
    c = manifest.cell(DOC, name)
    cfg = manifest.config(DOC, c["config"])
    tr = dict(manifest.traffic(c["traffic"]))
    tr["library"] = min(tr["library"], 4 * tr["batch_size"])
    lims = manifest.limits(name)
    nums = control.control_numbers(cfg, tr, 2 ** 31 + 17,
                                   torch.device("cuda"))
    assert any(nums[k] > lims[k] for k in lims if k in nums), nums
