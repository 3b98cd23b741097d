"""KVStore: the port of ``mxnet_tpu/kvstore.py`` (``local``, ``device``,
``dist_sync``, ``dist_device_sync``).

* ``local`` / ``device``: the values pushed for a key (one per device) are
  summed on the first one's device.
* ``dist_sync`` / ``dist_device_sync`` (``dist``, ``dist_tpu``): then
  summed over every rank with ``all_reduce`` on the default process group
  (:func:`mxnet_tpu_torch.parallel.collectives.world_sum`; NCCL on the
  card, gloo on the CPU).  Every rank must push the same keys in the same
  order, the reference's dist_sync contract.  Without a process group
  the cross-rank sum is the identity; with a group of one rank it is a
  real ``all_reduce`` over it.

``set_optimizer`` runs the optimizer in the store: a push then applies the
update with the summed gradient and a pull returns the updated weight
(the reference's server-side update).

Not ported yet (each raises ``NotImplementedError``, ROADMAP Queue 1 item
9): ``dist_async`` and its host parameter server, the host-resident rows
(``init_host_rows``, ``row_sparse_pull``) and gradient compression.
"""
from __future__ import annotations

import logging
import pickle

from . import optimizer as opt
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

_TODO = ("mxnet_tpu_torch: %s is not ported (ROADMAP Queue 1 item 9: the "
         "rest of kvstore)")


class KVStore:
    """Key-value store for parameter synchronization (reference:
    kvstore.py KVStore)."""

    def __init__(self, kv_type="local"):
        if kv_type == "dist_async":
            raise NotImplementedError(_TODO % "kvstore 'dist_async'")
        self._type = kv_type
        self._data = {}
        self._updater = None
        self._update_on_kvstore_flag = False
        self._str_key_dict = {}

    # -- identity ---------------------------------------------------------
    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        """This worker's rank in the default process group."""
        from . import _dist

        return _dist.rank()

    @property
    def num_workers(self):
        from . import _dist

        return _dist.world_size()

    # -- not ported --------------------------------------------------------
    def init_host_rows(self, key, shape, dtype="float32", initializer=None):
        raise NotImplementedError(_TODO % "init_host_rows")

    def host_row_stats(self, key):
        raise NotImplementedError(_TODO % "host_row_stats")

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise NotImplementedError(_TODO % "row_sparse_pull")

    def set_gradient_compression(self, compression_params):
        raise NotImplementedError(_TODO % "gradient compression")

    # -- init -------------------------------------------------------------
    def init(self, key, value):
        """Initialize a key with a value (reference: kvstore.init)."""
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        value = value if isinstance(value, NDArray) else value[0]
        self._data[key] = value.copy()

    # -- push / pull ------------------------------------------------------
    def push(self, key, value, priority=0, row_ids=None):
        """Push (a list of per-device) values; they are summed into the
        store, or, with an optimizer set, the sum is the gradient of one
        update of the stored weight."""
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.push(k, v, priority, row_ids=row_ids)
            return
        if row_ids is not None:
            raise NotImplementedError(_TODO % "push(row_ids=)")
        if isinstance(value, NDArray):
            value = [value]
        assert key in self._data, \
            "please init \"%s\" before push" % str(key)
        reduced = self._reduce(value)
        if self._updater is not None and self._update_on_kvstore_flag:
            idx = key if isinstance(key, int) else self._str_index(key)
            self._updater(idx, reduced, self._data[key])
        else:
            self._data[key]._set_data(reduced.data)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Pull the stored value into each output array."""
        if isinstance(key, (list, tuple)):
            for k, o in zip(key, out):
                self.pull(k, o, priority)
            return
        assert key in self._data, \
            "please init \"%s\" before pull" % str(key)
        outs = out if isinstance(out, (list, tuple)) else [out]
        src = self._data[key]
        for o in outs:
            o._set_data(src.as_in_context(o.context).data.clone())

    def pushpull(self, key, value, out=None, priority=0):
        """Push, then pull into ``out`` when given."""
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    # -- reduce -----------------------------------------------------------
    def _local_sum(self, values):
        if len(values) == 1:
            return values[0].copy()
        ctx0 = values[0].context
        total = values[0].as_in_context(ctx0).copy()
        for v in values[1:]:
            total += v.as_in_context(ctx0)
        return total

    def _reduce(self, values):
        """The local sum, then (dist types) the sum over every rank."""
        total = self._local_sum(values)
        if self._type.startswith("dist"):
            from .parallel.collectives import world_sum

            total = NDArray(world_sum(total.data))
        return total

    # -- optimizer placement ----------------------------------------------
    def set_optimizer(self, optimizer):
        """Run the optimizer in the store (a pickle round trip, as the
        reference sends it to its servers)."""
        self._updater = opt.get_updater(pickle.loads(pickle.dumps(optimizer)))
        self._update_on_kvstore_flag = True

    def set_updater(self, updater):
        """Install ``updater(key, recv_grad, local)``, applied on the store
        for every push."""
        self._updater = updater
        self._update_on_kvstore_flag = True

    _set_updater = set_updater

    def _str_index(self, key):
        if key not in self._str_key_dict:
            self._str_key_dict[key] = len(self._str_key_dict)
        return self._str_key_dict[key]

    # -- optimizer states / barrier ----------------------------------------
    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None, \
            "Cannot save states for distributed training"
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None, \
            "Cannot load states for distributed training"
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def _barrier(self):
        import torch.distributed as dist

        if self.num_workers > 1:
            dist.barrier()


def create(name="local"):
    """Create a KVStore: local / device / nccl / dist_sync /
    dist_device_sync / dist / dist_tpu (the dist types sum over the
    ranks; ``nccl`` is an alias of ``device``).  ``dist_async`` raises."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    known = ("local", "device", "nccl", "dist_sync", "dist_device_sync",
             "dist_async", "dist", "dist_tpu")
    if name not in known:
        raise ValueError("unknown KVStore type %s (known: %s)"
                         % (name, ", ".join(known)))
    store = KVStore(name)
    if name.startswith("dist") and store.num_workers == 1:
        logging.getLogger(__name__).warning(
            "kvstore %r created with a single worker process; cross-"
            "process reduce is a no-op. Launch workers via "
            "`python -m mxnet_tpu_torch.tools.launch -n N -- ...` for real "
            "distributed sync.", name)
    return store
