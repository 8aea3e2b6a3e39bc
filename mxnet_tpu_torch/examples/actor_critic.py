"""Gluon actor-critic on cart-pole.

A copy of the reference's ``examples/actor_critic.py`` on the port: a
shared body with a policy head and a value head, REINFORCE with the
critic's baseline from each episode's normalized returns, on an inline
cart-pole (the standard dynamics, Euler steps). The mean episode length
of the last 25 episodes must be 1.5x that of the first 25.

Run:  python -m mxnet_tpu_torch.examples.actor_critic --num-episodes 150
"""
import argparse

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples import common


class CartPole(object):
    """Classic cart-pole balance task (standard dynamics constants)."""

    def __init__(self, seed=0):
        self.rng = np.random.RandomState(seed)
        self.g, self.mc, self.mp, self.l = 9.8, 1.0, 0.1, 0.5
        self.force, self.dt = 10.0, 0.02
        self.x_lim, self.th_lim = 2.4, 12 * np.pi / 180

    def reset(self):
        self.s = self.rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        return self.s.copy()

    def step(self, action):
        x, xd, th, thd = self.s
        f = self.force if action == 1 else -self.force
        costh, sinth = np.cos(th), np.sin(th)
        m = self.mc + self.mp
        temp = (f + self.mp * self.l * thd ** 2 * sinth) / m
        thacc = (self.g * sinth - costh * temp) / \
            (self.l * (4.0 / 3.0 - self.mp * costh ** 2 / m))
        xacc = temp - self.mp * self.l * thacc * costh / m
        x, xd = x + self.dt * xd, xd + self.dt * xacc
        th, thd = th + self.dt * thd, thd + self.dt * thacc
        self.s = np.array([x, xd, th, thd], np.float32)
        done = abs(x) > self.x_lim or abs(th) > self.th_lim
        return self.s.copy(), 1.0, done


def build_net(pkg=mt):
    """The actor-critic net in ``pkg``'s Gluon (this package's by
    default): policy logits and value from a shared body."""
    nn = pkg.gluon.nn

    class ActorCritic(nn.HybridSequential):
        def __init__(self):
            super().__init__()
            # Block.__setattr__ registers Block-valued attributes
            self.body = nn.Dense(64, activation="relu", in_units=4)
            self.policy = nn.Dense(2, in_units=64)
            self.value = nn.Dense(1, in_units=64)

        def forward(self, x):
            h = self.body(x)
            return self.policy(h), self.value(h)

    return ActorCritic()


def episode_loss(pkg, net, states, actions, rets):
    """The actor's policy-gradient loss with the critic's baseline plus
    half the value regression, over one episode."""
    nd = pkg.nd
    logits, values = net(nd.array(np.stack(states)))
    logp = nd.log_softmax(logits, axis=-1)
    chosen = nd.pick(logp, nd.array(np.asarray(actions, np.float32)),
                     axis=1)
    values = nd.reshape(values, (-1,))
    adv = nd.array(rets) - values
    actor = -nd.mean(chosen * nd.stop_gradient(adv))
    critic = nd.mean(nd.square(adv))
    return actor + 0.5 * critic


def returns(rewards, gamma):
    """Discounted returns, normalized."""
    R, rets = 0.0, []
    for r in reversed(rewards):
        R = r + gamma * R
        rets.append(R)
    rets = np.asarray(rets[::-1], np.float32)
    return (rets - rets.mean()) / (rets.std() + 1e-6)


def main(argv=None):
    p = argparse.ArgumentParser(description="actor-critic cart-pole")
    p.add_argument("--num-episodes", type=int, default=150)
    p.add_argument("--max-steps", type=int, default=200)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    np.random.seed(args.seed)   # initializers draw from the global RNG

    net = build_net()
    net.initialize(mt.init.Xavier())
    trainer = mt.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": args.lr})
    env = CartPole(args.seed)
    rng = np.random.RandomState(args.seed + 1)

    lengths = []
    for ep in range(args.num_episodes):
        s = env.reset()
        states, actions, rewards = [], [], []
        for _ in range(args.max_steps):
            logits, _ = net(mt.nd.array(s[None]))
            z = logits.asnumpy()[0]
            probs = np.exp(z - z.max())    # stabilized softmax
            probs /= probs.sum()
            a = int(rng.rand() < probs[1])
            s2, r, done = env.step(a)
            states.append(s)
            actions.append(a)
            rewards.append(r)
            s = s2
            if done:
                break
        lengths.append(len(rewards))

        rets = returns(rewards, args.gamma)
        with mt.autograd.record():
            loss = episode_loss(mt, net, states, actions, rets)
        loss.backward()
        trainer.step(1)
        if (ep + 1) % 25 == 0:
            print("Episode[%d] mean-len(last 25)=%.1f"
                  % (ep + 1, np.mean(lengths[-25:])), flush=True)

    first = float(np.mean(lengths[:25]))
    last = float(np.mean(lengths[-25:]))
    print("mean episode length: first25=%.1f last25=%.1f" % (first, last))
    common.gate(last > first * 1.5, "actor-critic did not improve")
    return {"first25": first, "last25": last}


if __name__ == "__main__":
    main()
