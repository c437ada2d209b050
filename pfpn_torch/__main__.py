from .harness.cli import main

main()
