"""The references against the program's plain path, at a tiny width on
the CPU: the two UNets (eval, and train mode with dropout from one
generator), the ancestral sampler, the schedules, and one train step
with Adam and the EMA. They agree to float32 rounding."""

import copy

import numpy as np
import pytest
import torch

from perfbench.harness import inputs
from perfbench.reference import diffusion as rd
from perfbench.reference import unets
from perfbench.tests.tiny import tiny_cell

CELLS = {"fastdiffsr": "fastdiffsr_x4.train_b4", "ddpm": "sr3_x4.train_b4"}
SEED = 2 ** 31 + 77


def program_net(model):
    from fastdiffsr_tpu_torch.cli.infer import build_unet
    net = build_unet(model, device="cpu", seed=0)
    net.load_state_dict(inputs.make_weights(model, SEED, "cpu"), strict=True)
    return net


def reference_net(model):
    net = unets.build_unet(model)
    net.load_state_dict(inputs.make_weights(model, SEED, "cpu"))
    return net


@pytest.mark.parametrize("variant", sorted(CELLS))
@pytest.mark.parametrize("train", [False, True])
def test_unet_equals_program(variant, train):
    model = tiny_cell(CELLS[variant]).config["model"]
    prog, ref = program_net(model), reference_net(model)
    prog.train(train)
    ref.train(train)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 16, 16, 6), generator=g)
    level = torch.tensor([0.3, 0.9]) if variant == "fastdiffsr" else \
        torch.tensor([17.0, 503.0])
    with torch.no_grad():
        a = prog(x, level, generator=torch.Generator().manual_seed(9))
        b = ref(x, level, generator=torch.Generator().manual_seed(9))
    assert a.shape == b.shape == (2, 16, 16, 3)
    assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("schedule", ["linear", "linear_cosine"])
def test_schedule_equals_program(schedule):
    from fastdiffsr_tpu_torch.diffusion.schedules import make_beta_schedule
    opt = {"schedule": schedule, "n_timestep": 1000 if schedule == "linear"
           else 20, "linear_start": 1e-6, "linear_end": 1e-2}
    np.testing.assert_array_equal(
        rd.betas(opt), make_beta_schedule(schedule, opt["n_timestep"],
                                          1e-6, 1e-2))


@pytest.mark.parametrize("fused", [False, True])
def test_ancestral_sampler_equals_program(fused):
    from fastdiffsr_tpu_torch.cli import infer
    from fastdiffsr_tpu_torch.train import make_sample_fn, pad_batch_with_keys
    cell = tiny_cell("fastdiffsr_x4.infer_b1_f32")
    model = cell.config["model"]
    eng, _ = infer.build_all(cell.config, device="cpu")
    net = program_net(model)
    fn = make_sample_fn(eng, infer.make_denoiser(net, fused, torch.float32))
    _, cond = inputs.make_tiles(SEED, 2, 16, 4, "cpu")
    c, gens = pad_batch_with_keys(cond.numpy(), 2, SEED, 5, device="cpu")
    got = fn(c, gens)
    ref_gens = [torch.Generator().manual_seed(rd.image_seed(SEED, 5 + i))
                for i in range(2)]
    want = rd.sample_ancestral(reference_net(model), rd.tables(
        model["beta_schedule"]["val"], "cpu"), cond, ref_gens,
        "continuous_gamma", True)
    assert (got - want).abs().max() <= 1e-5


@pytest.mark.parametrize("variant", sorted(CELLS))
def test_train_step_equals_program(variant):
    from fastdiffsr_tpu_torch.cli import sr_mfe
    from fastdiffsr_tpu_torch.train import (create_train_state,
                                            make_optimizer, make_train_step,
                                            step_generator)
    cell = tiny_cell(CELLS[variant])
    opt = copy.deepcopy(cell.config)
    model = opt["model"]
    eng, _, net = sr_mfe.build_all(opt, "cpu", 0)
    net.load_state_dict(inputs.make_weights(model, SEED, "cpu"))
    state = create_train_state(net, make_optimizer(net.parameters(),
                                                   opt["train"]["optimizer"]))
    hr, sr = inputs.make_tiles(SEED, 2, 16, 4, "cpu")
    state, metrics = make_train_step(eng, ema_decay=0.5, ema_start=0)(
        state, {"HR": hr, "SR": sr}, step_generator(SEED, 0, "cpu"))

    ref = reference_net(model).train()
    w0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
    params = list(ref.parameters())
    ema = [p.detach().clone() for p in params]
    gen = torch.Generator().manual_seed(rd.step_seed(SEED, 0))
    loss = rd.training_loss(ref, rd.tables(model["beta_schedule"]["train"],
                                           "cpu"), hr, sr, gen, variant)
    grads = torch.autograd.grad(loss, params)
    rd.Adam(params, opt["train"]["optimizer"]["lr"]).step(list(grads))
    rd.ema_update(ema, [p.detach() for p in params], 0.5)

    assert abs(float(metrics["l_pix"]) - float(loss.detach())) <= \
        1e-6 * float(loss.detach())
    prog = dict(state.net.named_parameters())
    for (name, q), g, e in zip(ref.named_parameters(), grads, ema):
        m = state.optimizer.state[prog[name]]["exp_avg"] / (1 - rd.ADAM_B1)
        assert torch.allclose(m, g, rtol=0, atol=1e-5 * g.abs().max()
                              + 1e-12), name
        # an element whose gradient is ~0 moves by +-lr on rounding: hold
        # the leaf's move by its norm, as the output check does
        moved, want = prog[name].detach() - w0[name], q.detach() - w0[name]
        assert abs(moved.norm() - want.norm()) <= 1e-3 * want.norm(), name
        assert abs((state.ema_params[name] - w0[name]).norm()
                   - (e - w0[name]).norm()) <= 1e-3 * want.norm(), name
