"""The card-side comparison scripts of the port, on what the CPU can
hold: ``kernels.parity_dump``'s comparison of two dumps,
``kernels.flash_probe``'s ptxas summary, and that each script refuses
to run without a card (exit 1, no output file)."""
import torch

from paddle_tpu_torch.kernels import flash_probe, flash_train_timing
from paddle_tpu_torch.kernels import lstm_probe
from paddle_tpu_torch.kernels import parity_dump

_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__85b31df9_18_flash_attention_cu_2c1389792tc10dkv_kernelILi64EEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_PS2_S7_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__85b31df9_18_flash_attention_cu_2c1389792tc10dkv_kernelILi64EEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_PS2_S7_iiiif
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 8 bytes cumulative stack size, 1024 bytes smem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__85b31df9_18_flash_attention_cu_2c1389794tf3210fwd_kernelILi128EEEvPKfS3_S3_PfS4_iiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__85b31df9_18_flash_attention_cu_2c1389794tf3210fwd_kernelILi128EEEvPKfS3_S3_PfS4_iiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


def test_ptxas_summary_names_each_kernel_with_registers_and_spills():
    assert flash_probe.ptxas_summary(_LOG) == {
        "tc::dkv_kernelILi64EE": [168, 4],
        "tf32::fwd_kernelILi128EE": [255, 0]}
    assert flash_probe.ptxas_summary("") == {}


def test_parity_compare_holds_every_output_to_its_bits(tmp_path, capsys):
    a = {"x": torch.arange(6.0), "y": torch.ones(2, 3, dtype=torch.int8)}
    torch.save(a, tmp_path / "a.pt")
    torch.save({k: v.clone() for k, v in a.items()}, tmp_path / "b.pt")
    assert parity_dump.compare(tmp_path / "a.pt", tmp_path / "b.pt") == 0
    assert '"bit_equal": 2' in capsys.readouterr().out
    changed = dict(a, x=a["x"].clone())
    changed["x"][3] = torch.nextafter(changed["x"][3], torch.tensor(9.0))
    torch.save(changed, tmp_path / "c.pt")
    assert parity_dump.compare(tmp_path / "a.pt", tmp_path / "c.pt") == 1
    assert '"differ": ["x"]' in capsys.readouterr().out
    # a dtype change with equal values, or an output one side lacks
    torch.save(dict(a, y=a["y"].float()), tmp_path / "d.pt")
    assert parity_dump.compare(tmp_path / "a.pt", tmp_path / "d.pt") == 1
    torch.save({"x": a["x"]}, tmp_path / "e.pt")
    assert parity_dump.compare(tmp_path / "e.pt", tmp_path / "a.pt") == 1
    assert '"differ": ["y"]' in capsys.readouterr().out.splitlines()[-1]


def test_parity_compare_reports_redesigned_outputs_apart(tmp_path, capsys):
    """An output saved under the REDESIGNED prefix (a kernel the PR
    redesigns) is counted apart and may differ; every other one is held
    to its bits."""
    tag = parity_dump.REDESIGNED
    a = {"x": torch.arange(4.0), tag + "p": torch.ones(3)}
    torch.save(a, tmp_path / "a.pt")
    torch.save(dict(a, **{tag + "p": torch.zeros(3)}), tmp_path / "b.pt")
    assert parity_dump.compare(tmp_path / "a.pt", tmp_path / "b.pt") == 0
    out = capsys.readouterr().out
    assert '"bit_equal": 1' in out and '"redesigned": {"outputs": 1, ' \
        '"bit_equal": 0}' in out
    torch.save(dict(a, x=torch.zeros(4)), tmp_path / "c.pt")
    assert parity_dump.compare(tmp_path / "a.pt", tmp_path / "c.pt") == 1


def test_card_scripts_refuse_to_run_without_a_card(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "dump.pt"
    assert parity_dump.main(["--out", str(out)]) == 1
    assert flash_probe.main(["--out", str(tmp_path / "probe")]) == 1
    assert flash_train_timing.main([]) == 1
    assert lstm_probe.main(["--out", str(tmp_path / "lstm.json")]) == 1
    assert not out.exists() and not (tmp_path / "probe").exists()
    assert not (tmp_path / "lstm.json").exists()
    assert "no CUDA device" in capsys.readouterr().err
