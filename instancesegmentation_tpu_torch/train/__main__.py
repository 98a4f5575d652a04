from instancesegmentation_tpu_torch.train.loop import main

if __name__ == "__main__":
    main()
