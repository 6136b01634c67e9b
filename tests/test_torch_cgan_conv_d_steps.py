"""Two D updates a conv-CGAN step (``d_steps=2``) in eegsynth_torch
against eegsynth's, on the CPU, from ``test_torch_cgan_conv_train.py``'s
helpers and tolerances: the generator runs in train mode in each D update,
so the bn statistics advance three times in the step.
"""

from test_torch_cgan_conv_train import check_conv_state, run_conv_step_pair
from test_torch_cgan_train import check_step


def test_d_steps_2_advances_bn_three_times():
    """Two D updates, each with its own generator pass in train mode, then
    the G step: bn moves three times, D's optimizer counts two updates. R1
    is off here (its two passes would double the compile; the v1 steps hold
    it)."""
    got, want, hp, step = run_conv_step_pair("v1", d_steps=2, r1_gamma=0.0)
    check_step(got, want, hp, d_first_mu=step(n_d=1)[5].mu)
    check_conv_state(got, want)
    assert got[5].count == 2
