"""Model-zoo weight files: find (and check) pretrained ``.params``.

Counterpart of ``mxnet_tpu/gluon/model_zoo/model_store.py`` (reference
``python/mxnet/gluon/model_zoo/model_store.py``: ``get_model_file`` :63,
``purge``).  It resolves files locally and has no download leg:

* ``get_model_file(name, root)`` returns ``<root>/<name>.params`` when
  present (or the reference's ``<name>-<8hex>.params``), checked against
  an optional ``<name>.sha256`` sidecar; a missing file or a digest that
  differs raises.
* The file is what ``nd.load`` reads: the reference's dmlc binary format
  (a reference installation's ``save_parameters``) or this package's npz.
"""
from __future__ import annotations

import glob
import hashlib
import os

__all__ = ["get_model_file", "purge"]


def _default_root():
    return os.environ.get(
        "MXNET_HOME",
        os.path.join(os.path.expanduser("~"), ".mxnet", "models"))


def _candidates(name, root):
    exact = os.path.join(root, name + ".params")
    hashed = sorted(glob.glob(os.path.join(root, name + "-*.params")))
    return ([exact] if os.path.exists(exact) else []) + hashed


def _verify_sidecar(path, name, root):
    sidecar = os.path.join(root, name + ".sha256")
    if not os.path.exists(sidecar):
        return
    with open(sidecar) as f:
        fields = f.read().split()
    if not fields:
        raise ValueError(
            "sha256 sidecar %s is empty; put the expected hex digest in "
            "it or delete it to skip verification" % sidecar)
    want = fields[0].strip().lower()
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    if h.hexdigest() != want:
        raise ValueError(
            "model file %s fails its sha256 check (%s sidecar): the "
            "file is corrupt or was replaced" % (path, sidecar))


def get_model_file(name, root=None):
    """Path of the pretrained weights for model ``name``: ``<root>/<name>
    .params`` (or the reference's hashed ``<name>-xxxxxxxx.params``),
    checked against an optional ``<name>.sha256`` sidecar.  A missing
    file raises with conversion instructions (there is no download
    leg)."""
    root = os.path.expanduser(root) if root else _default_root()
    found = _candidates(name, root)
    if found:
        _verify_sidecar(found[0], name, root)
        return found[0]
    raise RuntimeError(
        "Pretrained weights for %r not found under %s, and this package "
        "downloads nothing. Convert a reference checkpoint instead: the "
        "reference's '%s-<hash>.params' file (python/mxnet/gluon/"
        "model_zoo/model_store.py) is the dmlc binary format this package "
        "reads bit-compatibly — copy it to %s" % (
            name, root, name, os.path.join(root, name + ".params")))


def purge(root=None):
    """Remove cached model files (reference: model_store.purge)."""
    root = os.path.expanduser(root) if root else _default_root()
    for pattern in ("*.params", "*.sha256"):  # stale sidecars would
        for f in glob.glob(os.path.join(root, pattern)):  # reject new files
            os.remove(f)
