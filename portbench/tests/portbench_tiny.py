"""Cells of ``BENCHMARK.json`` cut to sizes the CPU runs in seconds,
for the benchmark's own tests (the port's CPU path: plain PyTorch)."""
import copy
import time

from portbench import harness


def tiny_query(name: str = "fd-query-64") -> harness.Cell:
    c = harness.cell(name)
    c.config, c.traffic = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    c.config["deployment"].update(peers=8, items_per_peer=1000)
    c.traffic.update(queries_per_call=8, pool_calls=4, selections=8,
                     warm_calls=2, checked_share=1.0)
    return c


def tiny_train(name: str = "granite-train-4k") -> harness.Cell:
    """The port's smoke configuration of the architecture (f32
    parameters), as the configuration file's keys."""
    c = harness.cell(name)
    c.config, c.traffic = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    c.config["config"].update(
        num_hidden_layers=2, hidden_size=128, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, num_local_experts=4,
        num_experts_per_tok=2, vocab_size=512)
    c.config["port"].update(smoke=True, padded_vocab_size=2048,
                            param_dtype="float32")
    c.traffic.update(seq=32, batch=4)
    return c


def run(c, seed, seconds=0.3, **kw):
    return harness.execute(c, seed, seconds, False, "cpu",
                           time.perf_counter(), **kw)
