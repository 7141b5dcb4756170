"""The frozen yardstick gives the port's values at every shape the cells
run, so it starts equal to what the program reports."""

import pytest

from perfbench import costs
from perfbench.harness import traffic
from perfbench.reference import chatglm as ref
from perfbench.tests import cases


def _flash_shapes():
    """(B, S, H, hd) of every flash forward call the cells make."""
    out = set()
    for w in cases.bench()["workloads"]:
        cfg = cases.full_config(w["name"])
        mix = traffic.load(cases.ROOT, w["traffic"])
        out |= {(mix["batch"], n, cfg["num_attention_heads"],
                 cfg["kv_channels"]) for n in traffic.length_strata(mix)}
    return sorted(out)


@pytest.mark.parametrize("shape", _flash_shapes())
def test_flash_costs_equal_the_ports(shape):
    from repro_torch.kernels import costs as port
    mine = costs.kernel_cost("flash_attention")(shape, 2)
    theirs = port.flash_bound(shape, 2, causal=True)
    assert mine["bytes"] == theirs["bytes"]
    assert mine["flops"] == theirs["flops"]
    assert mine["bound_s"] * 1e3 == pytest.approx(theirs["bound_ms"],
                                                  rel=1e-12)
    assert mine["bound_by"] == theirs["bound_by"]


def test_kernel_bounds_add_over_calls():
    shapes = {(4, 512, 32, 128): 3, (4, 1024, 32, 128): 2}
    cost = costs.kernel_cost("flash_attention")
    want = sum(n * cost(s, 2)["bound_s"] for s, n in shapes.items())
    assert costs.kernel_bound_s("flash_attention", shapes) == want


def test_every_kernel_of_the_program_has_its_cost_or_none_is_read():
    """A roofline reader names a kernel of the program that has a cost
    file: the program's counter and the yardstick share the name."""
    from repro_torch.kernels import KERNELS
    assert "flash_attention" in KERNELS
    assert callable(costs.kernel_cost("flash_attention"))


def test_model_parameters_equal_the_ports():
    """The matmul weights the FLOP count takes, with the embedding, the
    output layer and the norms, are the port's parameter count."""
    from repro_torch.models.config import get_config
    cfg = cases.full_config()
    d, v, L = cfg["hidden_size"], cfg["padded_vocab_size"], cfg["num_layers"]
    everything = ref.matmul_params(cfg) + 2 * d * v + (2 * L + 1) * d
    assert everything == get_config(cfg["arch"]).n_params() == 6_243_454_976


@pytest.mark.parametrize("seq", [256, 1024, 2048])
def test_forward_flops_are_two_per_weight_and_token_and_attention(seq):
    cfg = cases.full_config()
    n = ref.matmul_params(cfg)
    attn = (cfg["num_layers"] * 4 * cfg["num_attention_heads"] * 4
            * cfg["kv_channels"] * seq * (seq + 1) / 2)
    head = 2 * 4 * cfg["hidden_size"] * cfg["padded_vocab_size"]
    assert ref.forward_flops(cfg, 4, seq, 4) == pytest.approx(
        2 * n * 4 * seq + attn + head, rel=1e-12)
