"""BucketingModule: variable-length training, one Module per bucket.

Counterpart of ``mxnet_tpu/module/bucketing_module.py`` (reference
``python/mxnet/module/bucketing_module.py``): ``sym_gen(bucket_key)``
gives each bucket's graph, the batch's ``bucket_key`` selects it, and a
bucket's Module is bound once, at its first batch's ``provide_data`` /
``provide_label``.  Every bucket's Module holds its own parameter arrays:
a switch copies the current bucket's parameters into the next, and all
buckets share one optimizer and Updater, so momentum carries across them.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, fixed_param_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise ValueError("BucketingModule needs a default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._grad_req = "write"
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    def _gen_symbol(self, key):
        res = self._sym_gen(key)
        if isinstance(res, tuple):
            return res                    # (sym, data_names, label_names)
        return res, ("data",), ("softmax_label",)

    def _module_for(self, bucket_key, data_shapes=None, label_shapes=None):
        """The bucket's Module, bound (and given the current parameters
        and the shared optimizer) the first time the key is seen."""
        if bucket_key not in self._buckets:
            if data_shapes is None:
                raise ValueError("new bucket %r needs shapes" % (bucket_key,))
            sym, dnames, lnames = self._gen_symbol(bucket_key)
            mod = Module(sym, data_names=dnames, label_names=lnames,
                         logger=self.logger, context=self._context,
                         fixed_param_names=self._fixed_param_names)
            mod.bind(data_shapes, label_shapes,
                     for_training=self.for_training, grad_req=self._grad_req)
            if self.params_initialized:
                ap, xp = self._curr_module.get_params()
                mod.init_params(arg_params=ap, aux_params=xp,
                                allow_missing=False, force_init=True)
                if self.optimizer_initialized:
                    mod._optimizer = self._curr_module._optimizer
                    mod._updater = self._curr_module._updater
                    mod.optimizer_initialized = True
            self._buckets[bucket_key] = mod
        return self._buckets[bucket_key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             force_rebind=False, grad_req="write"):
        """Bind the default bucket's Module."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self._grad_req = grad_req
        self._curr_module = self._module_for(self._default_bucket_key,
                                             data_shapes, label_shapes)
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s Module current, holding the parameters the
        current one has now."""
        if not self.binded:
            raise RuntimeError("BucketingModule: call bind first")
        mod = self._module_for(bucket_key, data_shapes, label_shapes)
        if self.params_initialized and mod is not self._curr_module:
            ap, xp = self._curr_module.get_params()
            mod.init_params(arg_params=ap, aux_params=xp, force_init=True)
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The current bucket's optimizer, shared by every bucket."""
        self._curr_module.init_optimizer(kvstore=kvstore,
                                         optimizer=optimizer,
                                         optimizer_params=optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod._optimizer = self._curr_module._optimizer
                mod._updater = self._curr_module._updater
                mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def _select(self, data_batch):
        key = data_batch.bucket_key
        if key is None:
            key = self._curr_bucket_key
        if key != self._curr_bucket_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)

    def forward(self, data_batch, is_train=None):
        """The forward of the batch's bucket (``bucket_key``; the current
        bucket when it has none)."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("BucketingModule: call bind and init_params "
                               "first")
        self._select(data_batch)
        self._curr_module.forward(data_batch, is_train=is_train)

    def forward_backward(self, data_batch):
        if not (self.binded and self.params_initialized):
            raise RuntimeError("BucketingModule: call bind and init_params "
                               "first")
        self._select(data_batch)
        self._curr_module.forward_backward(data_batch)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        """The current bucket's update; the others take its parameters
        when they become current."""
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels)

    @property
    def data_names(self):
        return self._curr_module.data_names

    @property
    def label_names(self):
        return self._curr_module.label_names

    @property
    def output_names(self):
        return self._curr_module.output_names
