"""parallel/multihost.init's backend check and the CLI's --backend, on the
CPU: torch.cuda's availability and device count and the process group's
initialisation are monkeypatched, so no card and no process group is
needed. NCCL takes one rank a card; init refuses more local ranks than
cards under NCCL before anything is initialised, and goes through with
gloo."""
import os
import sys

import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace_tpu_torch import cli
from raytrace_tpu_torch.parallel import multihost


@pytest.fixture
def fake_cards(monkeypatch):
    """torchrun's environment of rank 1 of 2 on one node, `cards` visible
    CUDA devices; returns (set the card count, the calls made)."""
    calls = {"init": [], "set_device": []}
    for k, v in {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
                 "LOCAL_WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls["init"].append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls["set_device"].append(i))
    monkeypatch.setattr(torch.cuda, "init", lambda: None)

    def cards(n):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)

    return cards, calls


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_init_refuses_nccl_with_more_local_ranks_than_cards(fake_cards, backend):
    cards, calls = fake_cards
    cards(1)
    with pytest.raises(ValueError, match=r"2 local ranks .* on 1 visible CUDA devices.*gloo"):
        multihost.init(backend, device="cuda")
    assert calls == {"init": [], "set_device": []}, "init went on after refusing"


@pytest.mark.parametrize("backend", [None, "nccl", "gloo"])
def test_init_without_cuda_names_cuda_not_nccl(fake_cards, monkeypatch, backend):
    """With no card the cause is CUDA's absence, whatever the backend: the
    NCCL count check (0 cards) must not speak first."""
    cards, calls = fake_cards
    cards(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"torch\.cuda\.is_available\(\) is False"):
        multihost.init(backend, device="cuda")
    assert calls == {"init": [], "set_device": []}


def test_init_takes_gloo_for_two_ranks_on_one_card(fake_cards):
    cards, calls = fake_cards
    cards(1)
    assert multihost.init("gloo", device="cuda") is True
    assert calls["set_device"] == [0]  # LOCAL_RANK 1 mod 1 card
    (backend, kw), = calls["init"]
    assert backend == "gloo" and kw["rank"] == 1 and kw["world_size"] == 2


def test_init_takes_nccl_with_a_card_a_rank(fake_cards):
    cards, calls = fake_cards
    cards(2)
    assert multihost.init(device="cuda") is True
    assert calls["set_device"] == [1]
    assert [b for b, _ in calls["init"]] == ["nccl"]


@pytest.mark.parametrize("flag", [None, "gloo", "nccl"])
def test_cli_passes_backend_to_init(monkeypatch, flag):
    seen = []
    monkeypatch.setattr(multihost, "init",
                        lambda backend=None, device="cuda": seen.append((backend, device)))
    monkeypatch.setattr(cli, "_main", lambda args: 0)
    argv = ["scheme.yml", "no_ui", "--device", "cpu"] + ([] if flag is None else
                                                         ["--backend", flag])
    assert cli.main(argv) == 0
    assert seen == [(flag, "cpu")]
