"""Deep Q-Network on cart-pole: a replay buffer and a target network.

A copy of the reference's ``examples/dqn.py`` on the port: off-policy
Q-learning with an experience replay buffer sampled uniformly, a frozen
target network synced every ``--target-sync`` steps and epsilon-greedy
exploration with decay, on the self-contained cart-pole of
:mod:`.actor_critic`'s kind. The mean length of the greedy evaluation
episodes must beat the random policy's by more than 2.5x.

Run:  python -m mxnet_tpu_torch.examples.dqn --num-episodes 100
"""
import argparse
import collections
import random

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples import common


class CartPole(object):
    """Classic cart-pole dynamics (Barto-Sutton-Anderson constants)."""

    def __init__(self, seed=0):
        self.rng = np.random.RandomState(seed)

    def reset(self):
        self.s = self.rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        return self.s.copy()

    def step(self, action):
        x, xd, th, thd = self.s
        f = 10.0 if action == 1 else -10.0
        ct, st = np.cos(th), np.sin(th)
        tmp = (f + 0.05 * thd * thd * st) / 1.1
        tha = (9.8 * st - ct * tmp) / (0.5 * (4.0 / 3 - 0.1 * ct * ct / 1.1))
        xa = tmp - 0.05 * tha * ct / 1.1
        self.s = np.array([x + 0.02 * xd, xd + 0.02 * xa,
                           th + 0.02 * thd, thd + 0.02 * tha], np.float32)
        done = bool(abs(self.s[0]) > 2.4 or abs(self.s[2]) > 0.21)
        return self.s.copy(), (0.0 if done else 1.0), done


def rollout_greedy(env, qfn, max_steps=300):
    s = env.reset()
    for t in range(max_steps):
        a = int(np.argmax(qfn(s)))
        s, r, done = env.step(a)
        if done:
            return t + 1
    return max_steps


def make_net(pkg=mt):
    """The Q-network in ``pkg``'s Gluon (this package's by default)."""
    nn = pkg.gluon.nn
    net = nn.Sequential()
    net.add(nn.Dense(64, activation="tanh"),
            nn.Dense(64, activation="tanh"), nn.Dense(2))
    return net


def td_loss(pkg, qnet, target, batch, gamma):
    """The mean squared TD error of ``batch`` against the frozen
    target's bootstrap ``r + gamma * max_a' Q_target(s', a')``."""
    nd = pkg.nd
    bs = nd.array(np.stack([b[0] for b in batch]))
    ba = np.array([b[1] for b in batch], np.int64)
    br = np.array([b[2] for b in batch], np.float32)
    bs2 = nd.array(np.stack([b[3] for b in batch]))
    bd = np.array([b[4] for b in batch], np.float32)
    q2 = target(bs2).asnumpy().max(axis=1)
    y = nd.array(br + gamma * q2 * (1 - bd))
    with pkg.autograd.record():
        q = qnet(bs)
        qa = nd.pick(q, nd.array(ba), axis=1)
        loss = nd.mean(nd.square(qa - y))
    return loss


def main(argv=None):
    p = argparse.ArgumentParser(description="DQN cart-pole")
    p.add_argument("--num-episodes", type=int, default=100)
    p.add_argument("--buffer", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--target-sync", type=int, default=200,
                   help="steps between target-network syncs")
    p.add_argument("--seed", type=int, default=3)
    args = p.parse_args(argv)
    np.random.seed(args.seed)
    random.seed(args.seed)

    qnet, target = make_net(), make_net()
    qnet.initialize(mt.init.Xavier())
    target.initialize(mt.init.Xavier())
    # the deferred shapes before the first sync
    dummy = mt.nd.array(np.zeros((1, 4), np.float32))
    qnet(dummy)
    target(dummy)

    def sync_target():
        # the two nets' names differ (Gluon's global counters): pair
        # the parameters by position
        src = list(qnet.collect_params().values())
        dst = list(target.collect_params().values())
        for sp, dp in zip(src, dst):
            dp.set_data(sp.data())

    sync_target()
    trainer = mt.gluon.Trainer(qnet.collect_params(), "adam",
                               {"learning_rate": args.lr})
    buf = collections.deque(maxlen=args.buffer)
    env = CartPole(seed=args.seed)

    def qfn(s):
        return qnet(mt.nd.array(s[None])).asnumpy()[0]

    baseline = float(np.mean([rollout_greedy(env,
                                             lambda s: np.random.rand(2))
                              for _ in range(20)]))
    eps, steps = 1.0, 0
    lengths = []
    for ep in range(args.num_episodes):
        s = env.reset()
        for t in range(200):
            eps = max(0.05, eps * 0.999)
            a = random.randrange(2) if random.random() < eps \
                else int(np.argmax(qfn(s)))
            s2, r, done = env.step(a)
            buf.append((s, a, r, s2, done))
            s = s2
            steps += 1
            if len(buf) >= args.batch_size and steps % 4 == 0:
                loss = td_loss(mt, qnet, target,
                               random.sample(buf, args.batch_size),
                               args.gamma)
                loss.backward()
                trainer.step(1)
            if steps % args.target_sync == 0:
                sync_target()
            if done:
                break
        lengths.append(t + 1)
        if (ep + 1) % 25 == 0:
            print("Episode[%d] mean-length(last 25)=%.1f eps=%.2f"
                  % (ep + 1, np.mean(lengths[-25:]), eps), flush=True)

    final = float(np.mean([rollout_greedy(env, qfn) for _ in range(10)]))
    print("greedy eval: %.1f steps (random baseline %.1f)"
          % (final, baseline))
    common.gate(final > 2.5 * baseline, "DQN did not learn to balance")
    return {"greedy": final, "baseline": baseline}


if __name__ == "__main__":
    main()
