# Port models against lfdtpu: eval-mode dense outputs of the TT100K and
# TrafficLight ZOO entries (CrossEntropy head with C+1 channels, no merge
# path; head without norm), same tolerance as the WIDERFACE file.
import pytest
import torch

from tests.test_torch_models_widerface import check_dense_outputs

torch.set_num_threads(1)


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)])
@pytest.mark.parametrize("name", ("TT100K-S", "TT100K-L", "TL-S", "TL-L"))
def test_dense_outputs_match_lfdtpu(name, hw):
    check_dense_outputs(name, hw)
