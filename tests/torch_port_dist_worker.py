"""One rank of the port's ``dist_sync`` KVStore test, started by
``python -m mxnet_tpu_torch.tools.launch -n 3 --platform cpu`` (the port's
counterpart of tests/dist_worker.py): each dense round must equal the sum
over the ranks bit for bit.  Imports no JAX."""
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mxnet_tpu_torch as mx  # noqa: E402  (joins the launcher's group)


def main(out_dir):
    ctx = mx.cpu()
    kv = mx.kv.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    assert nw == 3, "expected 3 workers, got %d" % nw

    shape = (4, 5)
    # 1. dense push/pull exact equality: sum of rank+1 = 1+2+3 = 6
    kv.init("w", mx.nd.zeros(shape, ctx=ctx))
    for _ in range(2):
        kv.push("w", mx.nd.ones(shape, ctx=ctx) * (rank + 1.0))
        out = mx.nd.zeros(shape, ctx=ctx)
        kv.pull("w", out=out)
        np.testing.assert_array_equal(out.asnumpy(), 6.0)

    # 2. a list of per-device values: local sum, then the sum over ranks
    kv.init(9, mx.nd.zeros(shape, ctx=ctx))
    kv.push(9, [mx.nd.ones(shape, ctx=ctx) * (rank + 1.0),
                mx.nd.ones(shape, ctx=ctx) * (rank + 1.0)])
    out = mx.nd.zeros(shape, ctx=ctx)
    kv.pull(9, out=out)
    np.testing.assert_array_equal(out.asnumpy(), 12.0)

    # 3. non-integer values: the sum of the ranks' arrays (within one
    #    rounding of each add; the parent checks every rank got the same bits)
    vals = [np.random.RandomState(i).randn(*shape).astype(np.float32)
            for i in range(nw)]
    kv.init("r", mx.nd.zeros(shape, ctx=ctx))
    out = mx.nd.zeros(shape, ctx=ctx)
    kv.pushpull("r", mx.nd.array(vals[rank], ctx=ctx), out=out)
    np.testing.assert_allclose(out.asnumpy(), np.sum(vals, 0), rtol=1e-6,
                               atol=1e-6)
    np.save(os.path.join(out_dir, "sum_%d.npy" % rank), out.asnumpy())

    # 4. the optimizer in the store: one SGD step with the summed gradient
    kv2 = mx.kv.create("dist_sync")
    kv2.init("p", mx.nd.ones(shape, ctx=ctx))
    kv2.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0))
    kv2.push("p", mx.nd.ones(shape, ctx=ctx) * (rank + 1.0))
    kv2.pull("p", out=out)
    np.testing.assert_allclose(out.asnumpy(), 1.0 - 0.1 * 6.0, rtol=1e-6)

    # 5. barrier, then a rank-stamped file for the parent to check
    kv._barrier()
    with open(os.path.join(out_dir, "worker_%d.ok" % rank), "w") as f:
        f.write("OK %d/%d\n" % (rank, nw))


if __name__ == "__main__":
    main(sys.argv[1])
