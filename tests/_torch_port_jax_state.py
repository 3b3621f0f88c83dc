"""A JAX ``AgentState`` for the port's tests without compiling ``init_state``.

Compiling the JAX agent's ``init_state`` costs seconds per configuration,
more than the checks that use it. Only the values matter to a test that
loads the same parameters into both agents, so :func:`agent_state` builds
the state ``init_state`` would build (eavit_tpu/rl/agent.py:165-205) around
parameter trees drawn with numpy in the shapes ``jax.eval_shape`` gives.
"""

import jax
import jax.numpy as jnp
import numpy as np

from eavit_tpu.rl import normalizer as jax_norm
from eavit_tpu.rl.agent import AgentState


def random_tree(shapes, seed: int):
    """A parameter tree in ``shapes`` drawn with numpy: LayerNorm scales 1 +
    N(0, 0.05), kernels N(0, 1 / fan_in), the rest (biases, positions,
    tokens) N(0, 0.05), so that every parameter takes part."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = getattr(path[-1], "key", "")
        x = rng.standard_normal(s.shape)
        if name == "scale":
            x = 1.0 + 0.05 * x
        elif name == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        else:
            x = 0.05 * x
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def agent_state(jag, seed: int) -> AgentState:
    """``jag.init_state``'s state with its parameter trees drawn (no SSL)."""
    shapes = jax.eval_shape(jag.init_state, jax.random.PRNGKey(0))
    assert shapes.ssl_target is None
    params = random_tree(shapes.params, seed)
    return AgentState(
        params=params,
        rnd_target=None if shapes.rnd_target is None else random_tree(shapes.rnd_target,
                                                                       seed + 1),
        ssl_target=None, opt_state=jag.tx.init(params),
        obs_rms=None if shapes.obs_rms is None else jax_norm.rms_init(shapes.obs_rms.mean.shape),
        reward_rms=jax_norm.rms_init(()),
        reward_filter=jax_norm.reward_filter_init(jag.cfg.num_env_per_process),
        global_step=jnp.zeros((2,), jnp.int32), global_update=jnp.zeros((), jnp.int32))
