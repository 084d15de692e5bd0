"""CLIP checkpoint registry and SHA256-verified download (counterpart of
``mudpt_tpu/models/download.py``, the reference's ``clip._MODELS`` /
``clip._download``, clip/clip.py:31-77).

Each registry URL carries its file's SHA256 as its second-to-last path
part; a download is verified against it and cached under ``~/.cache/clip``
by the URL's basename.  A cached file with the right digest is returned
without opening a URL, so a machine without network reads the ``.pt``
files placed there by hand (or takes ``MODEL.BACKBONE.PATH``).
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
import warnings

_MODELS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "RN50x64": "https://openaipublic.azureedge.net/clip/models/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}


def available_models() -> list:
    return list(_MODELS)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_model(name: str, root: str = "~/.cache/clip") -> str:
    """The local path of the named model's verified checkpoint under
    ``root``, downloaded first where it is absent or its digest is wrong."""
    if name not in _MODELS:
        raise KeyError(f"Unknown model {name!r}; available: {available_models()}")
    url = _MODELS[name]
    expected = url.split("/")[-2]
    root = os.path.expanduser(root)
    os.makedirs(root, exist_ok=True)
    target = os.path.join(root, os.path.basename(url))

    if os.path.isfile(target):
        if _sha256(target) == expected:
            return target
        warnings.warn(f"{target} exists but its SHA256 mismatches; re-downloading")
    with urllib.request.urlopen(url) as src, open(target, "wb") as dst:
        while True:
            buf = src.read(1 << 16)
            if not buf:
                break
            dst.write(buf)
    if _sha256(target) != expected:
        raise RuntimeError(f"Downloaded {name} but the SHA256 checksum mismatches")
    return target
