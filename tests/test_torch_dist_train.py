"""The FastDiffSR train step and the samplers on 2 and 3 gloo ranks
(separate processes, ``tests/torch_dist_worker.py``) against the same
code in this process without a process group, at the tiny UNet (inner 8,
groups 4, mults [1, 2], 16x16, dropout 0).

The train step: each rank draws the global batch's noise and noise level
(cached: its indices and flips) and keeps its rows, and DDP averages the
gradients, so 3 Adam + EMA steps on 2 ranks are the 1-rank steps but for
the order of float32 sums (the gradient is the mean of two half-batch
means). Losses agree within 1e-5 relative; the parameters and EMA after
3 steps within 2e-5 absolute (lr 2e-3: a rounding-size gradient
difference moves Adam's normalised update by far less than that except
where the gradient is ~eps, which these nets do not show). The chained
step's captured region (the bare net and one explicit all-reduce of its
gradients, run eagerly on gloo) equals DDP's unchained steps bit for
bit, dropout on.

The samplers: a rank samples its ``sample_rows`` of the batch with the
images' own generators, so the ranks' rows concatenated equal the
one-process batch (ancestral, DDIM with eta 0.5 and DPM-Solver++): bit
for bit on the plain forward, within FUSED_ATOL on the fused one, whose
CPU versions of K3/K2 sum in an order that follows the batch size (a
batch of 2 against one of 4 in one process differs by up to 3.6e-5
after 3 DPM steps; JAX's mesh-sampler bound is 5e-4). 3 ranks on a
batch of 4 leave the third rank idle (``auto_world`` 2)."""

import numpy as np
import pytest
import torch

from tests import torch_dist_worker as W

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
FUSED_ATOL = 1e-4


def _same_images(got, want, key):
    if key.endswith("_fused"):
        np.testing.assert_allclose(got, want, rtol=0, atol=FUSED_ATOL,
                                   err_msg=key)
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("case", ["train_step", "train_step_cached"])
def test_two_rank_train_steps_equal_one(case, tmp_path):
    want, want_p = W.train_step_case(cached=case.endswith("cached"))
    ranks = W.launch(case, 2, tmp_path / "out")
    for res, arrays in ranks:
        np.testing.assert_allclose(res["l_pix"], want["l_pix"],
                                   rtol=LOSS_RTOL)
        assert arrays.keys() == want_p.keys()
        for k, v in want_p.items():
            np.testing.assert_allclose(arrays[k], v, rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
    # the ranks hold one model: bit-equal to each other
    for k in want_p:
        np.testing.assert_array_equal(ranks[0][1][k], ranks[1][1][k])
    assert any(not np.array_equal(want_p[k], want_p[k.replace("p/", "ema/")])
               for k in want_p if k.startswith("p/"))


def test_two_rank_chained_steps_equal_ddp_steps(tmp_path):
    """2 gloo ranks: the chained train step's captured region run eagerly
    (the bare net, its gradients averaged by one explicit all-reduce,
    each sub-step's dropout from the rank generator its replay seeds),
    2 calls chained by 2, against 4 DDP-wrapped unchained steps from the
    same state: losses, gradient norms, parameters and EMA bit for bit
    on each rank, and the ranks bit-equal to each other (1/2 scales
    exactly, so the arithmetic is DDP's)."""
    ranks = W.launch("chain", 2, tmp_path / "out")
    for res, arrays in ranks:
        assert res["chained/step"] == res["unchained/step"] == 4
        for k in ("l_pix", "grad_norm"):
            assert res[f"chained/{k}"] == res[f"unchained/{k}"], k
        for k, v in arrays.items():
            if k.startswith("chained/"):
                np.testing.assert_array_equal(
                    v, arrays[k.replace("chained/", "unchained/", 1)],
                    err_msg=k)
    assert ranks[0][0] == ranks[1][0]
    for k, v in ranks[0][1].items():
        np.testing.assert_array_equal(v, ranks[1][1][k], err_msg=k)


@pytest.fixture
def one_thread():
    """The ranks run one thread each; so does the reference here, as a
    CPU convolution's sums follow the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_sampling_equals_one_process(world, tmp_path, one_thread):
    _, want = W.sample_case()
    ranks = W.launch("sample", world, tmp_path / "out")
    held = [a for _, a in ranks if a["rows"][1] > a["rows"][0]]
    assert len(held) == 2                  # auto_world(4, 2 or 3) == 2
    for key in want:
        if key == "rows":
            continue
        _same_images(np.concatenate([a[key] for a in held]), want[key], key)


def test_sampling_does_not_depend_on_grouping():
    """Per-image generators: a batch of 2 gives the first two images of a
    batch of 4 exactly (the JAX contract of ``tests/test_mesh_sampler.py``)."""
    _, four = W.sample_case(4)
    _, two = W.sample_case(2)
    for key in four:
        if key != "rows":
            _same_images(two[key], four[key][:2], key)
