from pngloss_jax.cli import main

main()
