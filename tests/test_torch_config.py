"""The port's layered configuration (util/config.py, ``-config``, ``-v``,
``cli scaffold``) against the JAX package's: one TOML file, one environment
variable and one CLI flag resolve to equal values on every flag that both
packages' commands share; the scaffold text is equal; a bad value refuses
only its own command; an explicit ``-config`` that does not exist raises;
``-v`` sets the verbosity; and no ``WEEDTPU_<COMMAND>_<FLAG>`` key collides
with a variable the port reads itself.  Every test runs with its own cwd
and search paths, so a stray ``weed-tpu.toml`` cannot leak in."""

from __future__ import annotations

import argparse
import os
import re
from pathlib import Path

import pytest

from seaweedfs_tpu import cli as jax_cli
from seaweedfs_tpu.util import config as jax_config
from seaweedfs_tpu.util import wlog as jax_wlog
from seaweedfs_tpu_torch import cli as port_cli
from seaweedfs_tpu_torch.commands import REGISTRY
from seaweedfs_tpu_torch.util import config as port_config
from seaweedfs_tpu_torch.util import wlog as port_wlog

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": (jax_cli, jax_config, jax_wlog), "port": (port_cli, port_config, port_wlog)}

TOML = """\
[master]
volumeSizeLimitMB = 512
mdir = "/srv/weed/master"
telemetryUrl = "http://127.0.0.1:23650/api/collect"
telemetryInterval = 300
port = 9444

[volume]
max = 3
mserver = "10.0.0.1:19333"
metricsPort = 9555
index = "compact"

[filer]
maxMB = 2

[s3]
accessKey = "AK"

[mq.broker]
port = 17001

[admin]
noEc = true
"""


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    """A cwd, a HOME and default search paths of the test's own, and no
    WEEDTPU_ variable from the outer environment."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    for key in [k for k in os.environ if k.startswith("WEEDTPU_")]:
        monkeypatch.delenv(key)
    for mod in (jax_config, port_config):
        monkeypatch.setattr(mod, "DEFAULT_CONFIG_PATHS", (str(tmp_path / "none.toml"),))
    for mod in (jax_wlog, port_wlog):
        monkeypatch.setattr(mod, "_verbosity", mod._verbosity)


def _subparsers(parser: argparse.ArgumentParser) -> dict:
    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return sub.choices


def _flags(p: argparse.ArgumentParser) -> dict:
    return {a.dest: a for a in p._actions if a.option_strings and a.dest != "help"}


def test_one_file_one_env_one_flag_resolve_equally_on_every_shared_flag(tmp_path, monkeypatch):
    path = tmp_path / "weed-tpu.toml"
    path.write_text(TOML)
    monkeypatch.setenv("WEEDTPU_MASTER_TELEMETRYINTERVAL", "1")
    monkeypatch.setenv("WEEDTPU_MASTER_PORT", "9333")
    parsers = {}
    for name, (cli, config, _wlog) in PACKAGES.items():
        parsers[name] = cli._build_parser(config.load_config_file(str(path)))
    jax_subs, port_subs = (_subparsers(parsers[n]) for n in ("jax", "port"))
    shared = sorted(set(jax_subs) & set(port_subs))
    assert set(jax_subs) == set(port_subs) and len(shared) == 33
    compared = 0
    for cmd in shared:
        jflags, pflags = _flags(jax_subs[cmd]), _flags(port_subs[cmd])
        for dest in sorted(set(jflags) & set(pflags)):
            assert jflags[dest].option_strings == pflags[dest].option_strings, (cmd, dest)
            assert jax_subs[cmd].get_default(dest) == port_subs[cmd].get_default(dest), (cmd, dest)
            compared += 1
    assert compared == 220
    master = port_subs["master"]
    # the file's values, the environment over the file, the defaults elsewhere
    assert (master.get_default("volumeSizeLimitMB"), master.get_default("mdir"),
            master.get_default("telemetryInterval"), master.get_default("port"),
            master.get_default("defaultReplication")) == (512, "/srv/weed/master", 1.0, 9333, "000")
    assert port_subs["mq.broker"].get_default("port") == 17001
    assert port_subs["admin"].get_default("noEc") is True
    # a CLI flag beats the environment and the file, in both
    argv = ["-config", str(path), "master", "-port", "0", "-telemetryInterval", "2"]
    got = {n: vars(parsers[n].parse_args(argv)) for n in PACKAGES}
    for args in got.values():
        assert (args["port"], args["telemetryInterval"], args["volumeSizeLimitMB"]) == (0, 2.0, 512)
    keys = set(got["jax"]) & set(got["port"]) - {"_run"}
    assert {k: got["jax"][k] for k in keys} == {k: got["port"][k] for k in keys}


def test_the_device_flag_takes_the_layers_and_still_raises_without_cuda(tmp_path, monkeypatch):
    """``-device`` from the environment is an explicit ask: it is taken as
    given, and ``cuda`` on a machine without CUDA raises as a flag does."""
    monkeypatch.setenv("WEEDTPU_EC_ENCODE_LOCAL_DEVICE", "cpu")
    parser = port_cli._build_parser(port_config.load_config_file(None))
    assert _subparsers(parser)["ec.encode.local"].get_default("device") == "cpu"
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("WEEDTPU_EC_ENCODE_LOCAL_DEVICE", "cuda")
    (tmp_path / "1.dat").write_bytes(bytes([3, 0, 0, 0, 0, 0, 0, 0]) + bytes(4096))
    (tmp_path / "1.idx").write_bytes(b"")
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        port_cli.main(["ec.encode.local", "-dir", str(tmp_path), "-volumeId", "1"])


def test_scaffold_prints_the_same_text(capsys):
    outs = []
    for cli, config, _wlog in PACKAGES.values():
        assert cli.main(["scaffold"]) == 0
        outs.append(capsys.readouterr().out)
        assert outs[-1] == config.SCAFFOLD
    assert outs[0] == outs[1]
    parsed = port_config.tomllib.loads(outs[1])
    assert set(parsed) == {"master", "volume", "filer", "s3", "webdav", "mq"}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_bad_value_refuses_only_its_own_command(pkg, tmp_path, capsys):
    cli = PACKAGES[pkg][0]
    path = tmp_path / "bad.toml"
    path.write_text('[volume]\nmax = "lots"\n')
    assert cli.main(["-config", str(path), "volume", "-dir", str(tmp_path)]) == 1
    assert "error: config value for -max ('lots')" in capsys.readouterr().err
    assert cli.main(["-config", str(path), "scaffold"]) == 0
    assert "[mq.broker]" in capsys.readouterr().out


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_an_explicit_config_that_does_not_exist_raises(pkg, tmp_path):
    cli = PACKAGES[pkg][0]
    with pytest.raises(FileNotFoundError):
        cli.main(["-config", str(tmp_path / "nope.toml"), "scaffold"])
    with pytest.raises(FileNotFoundError):
        cli.main([f"-config={tmp_path / 'nope.toml'}", "scaffold"])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_v_sets_the_verbosity(pkg, capsys):
    cli, _config, wlog = PACKAGES[pkg]
    wlog.set_verbosity(0)
    assert not wlog.V(2)
    assert cli.main(["-v", "2", "scaffold"]) == 0
    assert wlog.V(2) and not wlog.V(3)
    capsys.readouterr()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_the_default_search_path_is_read_when_present(pkg, tmp_path, monkeypatch):
    """Without ``-config`` the first default path that exists is read (the
    search paths here are the test's own: ./weed-tpu.toml, then HOME's)."""
    cli, config, _wlog = PACKAGES[pkg]
    home = tmp_path / ".seaweedfs_tpu"
    home.mkdir()
    (home / "weed-tpu.toml").write_text("[volume]\nmax = 5\n")
    monkeypatch.setattr(config, "DEFAULT_CONFIG_PATHS",
                        ("./weed-tpu.toml", str(home / "weed-tpu.toml")))
    parser = cli._build_parser(config.load_config_file(cli._config_path([])))
    assert _subparsers(parser)["volume"].get_default("max") == 5
    (tmp_path / "weed-tpu.toml").write_text("[volume]\nmax = 6\n")
    parser = cli._build_parser(config.load_config_file(cli._config_path([])))
    assert _subparsers(parser)["volume"].get_default("max") == 6


class TestConfigLayers:
    """tests/test_config_debug.py's layering cases, on both packages."""

    def _parser(self):
        p = argparse.ArgumentParser()
        p.add_argument("-port", type=int, default=8080)
        p.add_argument("-mserver", default="127.0.0.1:19333")
        p.add_argument("-max", type=int, default=8)
        p.add_argument("-readOnly", action="store_true")
        return p

    @pytest.mark.parametrize("pkg", sorted(PACKAGES))
    def test_toml_sets_defaults_cli_wins(self, pkg, tmp_path):
        config_mod = PACKAGES[pkg][1]
        cfg_file = tmp_path / "weed-tpu.toml"
        cfg_file.write_text(
            '[volume]\nport = 9090\nmserver = "10.0.0.1:19333"\nreadOnly = true\n')
        config = config_mod.load_config_file(str(cfg_file))
        p = self._parser()
        config_mod.apply_to_parser(p, "volume", config)
        args = p.parse_args([])
        assert (args.port, args.mserver, args.readOnly, args.max) == (
            9090, "10.0.0.1:19333", True, 8)
        assert p.parse_args(["-port", "7070"]).port == 7070

    @pytest.mark.parametrize("pkg", sorted(PACKAGES))
    def test_env_beats_file(self, pkg, tmp_path, monkeypatch):
        config_mod = PACKAGES[pkg][1]
        cfg_file = tmp_path / "c.toml"
        cfg_file.write_text("[volume]\nport = 9090\n")
        monkeypatch.setenv("WEEDTPU_VOLUME_PORT", "6060")
        monkeypatch.setenv("WEEDTPU_VOLUME_READONLY", "yes")
        p = self._parser()
        config_mod.apply_to_parser(p, "volume", config_mod.load_config_file(str(cfg_file)))
        args = p.parse_args([])
        assert (args.port, args.readOnly) == (6060, True)

    @pytest.mark.parametrize("pkg", sorted(PACKAGES))
    def test_dotted_command_sections(self, pkg, tmp_path):
        config_mod = PACKAGES[pkg][1]
        cfg_file = tmp_path / "c.toml"
        cfg_file.write_text("[mq.broker]\nport = 17000\n")
        config = config_mod.load_config_file(str(cfg_file))
        assert config_mod.section_defaults(config, "mq.broker") == {"port": 17000}
        assert config_mod.section_defaults(config, "mq") == {}
        assert config_mod._env_key("mq.broker", "port") == "WEEDTPU_MQ_BROKER_PORT"

    @pytest.mark.parametrize("pkg", sorted(PACKAGES))
    def test_bad_toml_raises(self, pkg, tmp_path):
        config_mod = PACKAGES[pkg][1]
        cfg_file = tmp_path / "bad.toml"
        cfg_file.write_text("[volume\nport=")
        with pytest.raises(ValueError, match="config .*bad.toml"):
            config_mod.load_config_file(str(cfg_file))

    @pytest.mark.parametrize("pkg", sorted(PACKAGES))
    def test_missing_explicit_file_raises(self, pkg, tmp_path, monkeypatch):
        config_mod = PACKAGES[pkg][1]
        with pytest.raises(FileNotFoundError):
            config_mod.load_config_file(str(tmp_path / "nope.toml"))
        monkeypatch.setattr(config_mod, "DEFAULT_CONFIG_PATHS",
                            (str(tmp_path / "a.toml"), str(tmp_path / "b.toml")))
        assert config_mod.load_config_file(None) == {}


def test_no_env_key_collides_with_a_variable_the_port_reads():
    """Every WEEDTPU_ variable that the port's code names is read for its
    own meaning (the TLS files, the verbosity); no command's flag maps onto
    one of them.  ``tls.gen`` normalises to WEEDTPU_TLS_GEN_*, clear of
    WEEDTPU_TLS_CA / CERT / KEY."""
    read = set()
    for path in (REPO / "seaweedfs_tpu_torch").rglob("*.py"):
        if path.name == "config.py":
            continue
        read |= set(re.findall(r"WEEDTPU_[A-Z0-9_]+", path.read_text()))
    read = {k for k in read if not k.endswith("_")}
    assert {"WEEDTPU_TLS_CA", "WEEDTPU_TLS_CERT", "WEEDTPU_TLS_KEY", "WEEDTPU_V"} <= read
    parser = port_cli._build_parser()
    keys = {port_config._env_key(cmd, a.option_strings[0].lstrip("-"))
            for cmd, p in _subparsers(parser).items() for a in _flags(p).values()}
    assert len(keys) > 200
    assert not keys & read
    assert port_config._env_key("tls.gen", "dir") == "WEEDTPU_TLS_GEN_DIR"
    assert set(REGISTRY) == set(_subparsers(parser))
