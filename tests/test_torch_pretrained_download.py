"""The download branch of the port's ``resolve_pretrained``
(``refign_tpu_torch/utils/pretrained.py``), the JAX module's
(``refign_tpu/utils/pretrained.py:124-139``): a URL missing from the
torch-hub cache is fetched there with
``torch.hub.download_url_to_file(source, cache, progress=False)``; a
failure raises RuntimeError naming the file to place.  The download
function is monkeypatched (to write a file, then to raise): nothing is
fetched.  Both packages are run under the same patch and agree.
"""
import os

import pytest
import torch
import torch.hub

from refign_tpu.utils import pretrained as jax_pretrained
from refign_tpu_torch.utils import pretrained

URL = "https://download.pytorch.org/models/vgg16-397923af.pth"


@pytest.fixture
def hub(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "th"))
    return tmp_path / "th" / "hub" / "checkpoints" / "vgg16-397923af.pth"


@pytest.mark.parametrize("module", [pretrained, jax_pretrained])
def test_a_miss_downloads_into_the_hub_cache(module, hub, monkeypatch):
    calls = []

    def fake_download(source, dst, progress=True):
        calls.append((source, dst, progress))
        torch.save({"w": torch.ones(1)}, dst)

    monkeypatch.setattr(torch.hub, "download_url_to_file", fake_download)
    got = module.resolve_pretrained("imagenet", family="vgg",
                                    model_type="vgg16")
    assert got == str(hub) and os.path.exists(got)
    assert calls == [(URL, str(hub), False)]
    # the cached file is found without another download
    assert module.resolve_pretrained(URL) == str(hub)
    assert len(calls) == 1


@pytest.mark.parametrize("module", [pretrained, jax_pretrained])
def test_a_failed_download_raises_with_the_place(module, hub, monkeypatch):
    def failing(source, dst, progress=True):
        raise OSError("no route to host")

    monkeypatch.setattr(torch.hub, "download_url_to_file", failing)
    with pytest.raises(RuntimeError) as err:
        module.resolve_pretrained(URL)
    msg = str(err.value)
    assert str(hub) in msg and "OSError: no route to host" in msg
    assert "manually" in msg
    assert isinstance(err.value.__cause__, OSError)
    assert not os.path.exists(hub)
