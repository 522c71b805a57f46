"""Port parity: the four command lines take the JAX package's flags.

Each of the port's CLIs (``launch.train``, ``launch.train_fleet``,
``launch.serve``, ``launch.fleet``) against its JAX twin: the same
options, each with the same destination, default, choices, action and
type, up to the port's own ``--device``. An argv written for the JAX CLI
parses in the port's.
"""

import argparse

import pytest

pytest.importorskip("torch")

from repro.launch import fleet as j_fleet  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.launch import train_fleet as j_train_fleet  # noqa: E402
from repro_torch.launch import fleet  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch import train_fleet  # noqa: E402


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _jax_serve_parser(monkeypatch):
    """The JAX serve CLI builds its parser inside ``main``: stop it there."""
    def stop(self, args=None, namespace=None):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as caught:
        j_serve.main()
    monkeypatch.undo()
    return caught.value.parser


def _flags(parser):
    """{option: (dest, default, choices, action, type, nargs)}."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        for opt in a.option_strings:
            out[opt] = (a.dest, a.default,
                        None if a.choices is None else sorted(a.choices),
                        type(a).__name__, getattr(a.type, "__name__", None),
                        a.nargs)
    return out


PAIRS = {
    "train": (j_train.build_argparser, train.build_argparser),
    "train_fleet": (j_train_fleet.build_argparser,
                    train_fleet.build_argparser),
    "serve": (None, serve.build_parser),
    "fleet": (j_fleet.build_argparser, fleet.build_argparser),
}


@pytest.mark.parametrize("cli", sorted(PAIRS))
def test_port_cli_takes_the_jax_flags(cli, monkeypatch):
    jax_parser, port_parser = PAIRS[cli]
    want = _flags(jax_parser() if jax_parser else
                  _jax_serve_parser(monkeypatch))
    got = _flags(port_parser())
    assert got.pop("--device")[1] == "cuda"
    assert got == want
